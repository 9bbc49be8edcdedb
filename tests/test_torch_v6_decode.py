"""The port's whole-stack RWKV-6 decode step (``ops/cuda/layer56``; its
plain version on the CPU) against the JAX package's
``layer56.layer_scan56`` (Pallas in interpret mode) and against the
port's per-layer path, and the Engine's use of it.

Tolerances: against JAX, layer 0's states at 1e-5·max (the same f32
function summed in another order) and every output at 3e-2·max, the
Q4_K_M tolerance of tests/test_torch_forward.py (a bf16 operand rounding
flipped in layer 0 carries into later layers). Against the port's
per-layer path, which runs the same function at these sizes (every
matrix in the gemv class), 1e-6·max. The largest errors seen are
recorded beside each test.
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
from web_rwkv_gguf_tpu.ops.pallas.layer56 import layer_scan56 as jax_layer_scan56
from web_rwkv_gguf_tpu.ops.pallas.layer56 import prep_decode56 as jax_prep_decode56
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    embed_tokens, forward_chunk, init_state, load_model, logits_head, make_generator,
    prepare_decode,
)
from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, LN_EPS
from web_rwkv_gguf_tpu_torch.ops.cuda.layer56 import (
    MAX_SCAN_BATCH, layer_scan56, mega_layers, prep_decode56,
)
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf, make_v7_gguf

VOCAB = 300
SMALL = dict(n_layer=3, n_emb=256, head_size=64, n_vocab=VOCAB, n_hidden=1024, rank_tm=8,
             rank_td=8)


@pytest.fixture(scope="module")
def q4k_file():
    return make_v6_gguf(**SMALL, quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K,
                        seed=5)


@pytest.fixture(scope="module")
def port_model(q4k_file):
    return load_model(GgufFile(q4k_file), device="cpu")


def _tokens(B, step):
    return (np.arange(B)[:, None] * 5 + 3 + 4 * step) % VOCAB


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("B", [1, 5])
def test_layer_scan56_matches_jax(q4k_file, port_model, B):
    """Two decode steps from a zero state, all lanes live (largest errors
    seen: layer 0 1.6e-6 of max, every output 3.1e-3)."""
    info, params = port_model
    mega = prepare_decode(params, info, B)["mega56"]
    jinfo, jparams = jax_load_model(JaxGgufFile(q4k_file))
    jmega = jax_prep_decode56(jparams, jinfo)
    st, jst = init_state(info, B, device="cpu"), jax_init_state(jinfo, B)
    pcfg.interpret = True
    try:
        for step in range(2):
            tok = _tokens(B, step)
            x = embed_tokens(params, torch.tensor(tok))[:, 0]
            xo, st = layer_scan56(mega, st, x, torch.ones(B), None, LN_EPS, GN_EPS)
            jx = jax_embed(jparams, jnp.asarray(tok))[:, 0]
            jxo, jst = jax_layer_scan56(jmega, jst, jx, jnp.ones((B,), jnp.float32), None,
                                        LN_EPS, GN_EPS)
            assert _rel(xo, jxo) <= 3e-2
            for key in jst:
                assert _rel(st[key][0], jst[key][0]) <= 1e-5, key
                assert _rel(st[key], jst[key]) <= 3e-2, key
    finally:
        pcfg.interpret = False


@pytest.mark.parametrize("B,rescale", [(1, None), (5, None), (5, 2)])
def test_layer_scan56_matches_the_per_layer_path(port_model, B, rescale):
    """Three steps through ``forward_chunk`` with and without the decode
    blocks; at B=5 lane 2 is frozen on the second step (its state kept,
    as the per-layer path keeps it; largest error seen: 0)."""
    info, params = port_model
    prepared = prepare_decode(params, info, B)
    assert "mega56" in prepared
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


def _random_state(info, B, seed):
    L, C, H, hs = info.num_layer, info.num_emb, info.num_head, info.head_size
    g = torch.Generator().manual_seed(seed)
    return {"att_shift": torch.randn(L, B, C, generator=g),
            "wkv": torch.randn(L, B, H, hs, hs, generator=g),
            "ffn_shift": torch.randn(L, B, C, generator=g)}


@pytest.mark.parametrize("rescale", [None, 2])
def test_layer_scan56_slices_compose(port_model, rescale):
    """One-layer slices (``mega_layers`` with ``first_layer``), each fed
    the previous slice's x, give the whole stack exactly (the rescale
    counted by global layer); this is how chip_smoke.py holds the kernel
    layer by layer."""
    info, params = port_model
    mega = prepare_decode(params, info, 2)["mega56"]
    state = _random_state(info, 2, 3)
    x = embed_tokens(params, torch.tensor([[7], [9]]))[:, 0]
    mask = torch.tensor([1.0, 0.0])
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


def test_mask_zero_leaves_the_state_unchanged(port_model):
    """A lane with mask 0 keeps every state array bit for bit, from a
    random state (the blend m·S_n + (1 − m)·S is exact at 0)."""
    info, params = port_model
    mega = prepare_decode(params, info, 3)["mega56"]
    state = _random_state(info, 3, 4)
    x = embed_tokens(params, torch.tensor([[1], [2], [3]]))[:, 0]
    _, new = layer_scan56(mega, state, x, torch.tensor([1.0, 0.0, 1.0]), None, LN_EPS,
                          GN_EPS)
    for key in state:
        assert torch.equal(new[key][:, 1], state[key][:, 1])
        assert not torch.equal(new[key][:, 0], state[key][:, 0])


def test_prepare_decode_takes_only_what_the_kernel_runs(port_model):
    info, params = port_model
    prepared = prepare_decode(params, info, MAX_SCAN_BATCH)
    assert "mega56" in prepared and "mega7" not in prepared
    assert prepare_decode(prepared, info, 2) is prepared  # idempotent
    assert "mega56" not in prepare_decode(params, info, MAX_SCAN_BATCH + 1)
    assert "mega56" not in prepare_decode({**params, "blocks": [params["blocks"]]}, info, 1)
    # dense f32 layers, a head size of 32, ranks not multiples of 8
    for kw, dtype in ((dict(), torch.float32),
                      (dict(n_emb=256, head_size=32, quantize=GgmlDType.Q4_K), torch.bfloat16),
                      (dict(n_emb=256, head_size=64, rank_tm=4, quantize=GgmlDType.Q4_K),
                       torch.bfloat16)):
        full = {**SMALL, "n_layer": 1, **kw}
        inf_, par = load_model(GgufFile(make_v6_gguf(**full, seed=2)), dtype=dtype,
                               device="cpu")
        assert prep_decode56(par, inf_) is None
        assert "mega56" not in prepare_decode(par, inf_, 1)
    # dense bf16 layers at head size 64 take the dense slot, as the JAX
    # package's prep_decode56 takes them
    inf_, par = load_model(GgufFile(make_v6_gguf(**{**SMALL, "n_layer": 1}, seed=2)),
                           device="cpu")
    assert prep_decode56(par, inf_) is not None
    assert "mega56" in prepare_decode(par, inf_, 1)
    # a V7 model takes its own blocks
    v7 = load_model(GgufFile(make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=64,
                                          n_hidden=512, quantize=GgmlDType.Q4_K, seed=2)),
                    device="cpu")
    assert prep_decode56(v7[1], v7[0]) is None
    assert "mega7" in prepare_decode(v7[1], v7[0], 1)


def test_engine_decodes_through_the_whole_stack_step(port_model):
    """The Engine arranges the V6 decode blocks, and its greedy tokens
    equal the per-layer path's: one chunk of prefill, then
    ``make_generator`` on the loaded params."""
    info, params = port_model
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    assert "mega56" in eng.params and "mega56" not in params
    prompts = [[5, 9, 11, 2, 7, 8, 1, 0], [3, 1, 4, 1, 5, 9, 2, 6]]
    got = eng.generate(prompts, 6, segment=5)
    st = init_state(info, 2, device="cpu")
    x, st = forward_chunk(info, params, st, torch.tensor(prompts), torch.tensor([8, 8]))
    first = torch.argmax(logits_head(params, x[:, -1]), dim=-1)
    toks, *_ = make_generator(info, steps=5)(params, st, first[:, None])
    want = [[int(f)] + t for f, t in zip(first, toks.tolist())]
    assert got == want
