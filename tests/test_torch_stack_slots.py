"""The slots of the whole-stack decode kernels that Q6_K / Q3_K, Q4_0 /
Q4_1 and dense bf16 layer matrices take (``ops/cuda/layer7.stack_matrix``:
native Q6_K / Q3_K factors, f32 group scales over split-halves nibbles,
bf16 weights), through the port against the JAX package on the CPU:

- the whole-stack step's plain version (``layer_scan7_plain``,
  ``layer_scan56_plain``) against JAX ``layer_scan7`` / ``layer_scan56``
  (Pallas in interpret mode), two decode steps at B = 1 and 5: layer 0's
  att_shift and WKV state (RWKV-4: aa, bb, pp) at 1e-5·max, the same f32
  function summed in another order, its ffn_shift at 2^-8·max (one bf16
  step of Wo's input flipped by that order, as in
  tests/test_torch_kquants_decode.py), every output at 3e-2·max (a
  flipped bf16 operand rounding in layer 0 carries into later layers).
  Q3_K's layer-0 WKV state is held at 5e-5·max: the JAX slot for Q6_K /
  Q3_K codes sums (192 + q)·s·x and subtracts 192·s·Σx, and with Q3_K's
  codes in [-4, 3] the cancelled sums are ~48 times the products, so the
  JAX kernel's state lies 1.7e-5 of max from the f64 function where the
  port's lies 2.1e-7 (seed 301, B=5; Q6_K: 2.8e-6 and 1.8e-7); the port's
  slot products are held against f64 at 1e-6 below;
- against the port's per-layer path at 1e-6·max: at these widths every
  quantized matrix of the per-layer path takes its gemv at B ≤ 5 and a
  dense one the same bf16 product, so both compute the same function;
- the Engine's greedy tokens against the per-layer path's.

Dense f32 stacks stay on the per-layer path (the JAX slot rounds them to
bf16; the port's f32 files are its reference class).
"""

import functools

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
from web_rwkv_gguf_tpu.ops.pallas.layer56 import layer_scan56 as jax_layer_scan56
from web_rwkv_gguf_tpu.ops.pallas.layer56 import prep_decode56 as jax_prep_decode56
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    embed_tokens, forward_chunk, init_state, load_model, logits_head, make_generator,
    prepare_decode,
)
from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
from web_rwkv_gguf_tpu_torch.ops.cuda.layer7 import (
    FORM_DENSE, FORM_Q6K, FORM_QS_NIB, descriptor, layer_scan7, slot_gemv_plain, stack_matrix,
)
from web_rwkv_gguf_tpu_torch.ops.cuda.layer56 import layer_scan56
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine
from web_rwkv_gguf_tpu_torch.utils import synthetic

VOCAB = 64
OUT_TOL = 3e-2
LAYER0_TOL = {"att_shift": 1e-5, "wkv": 1e-5, "aa": 1e-5, "bb": 1e-5, "pp": 1e-5,
              "ffn_shift": 2.0 ** -8}
Q3K_WKV_TOL = 5e-5
PER_LAYER_TOL = 1e-6
F64_TOL = 1e-6
WIDTHS = {"v7": dict(head_size=64), "v6": dict(head_size=64, rank_tm=8, rank_td=8),
          "v5": dict(head_size=64), "v4": {}}
# (version, block type or None for an f16 file loaded as bf16) and its slot:
# (form, signed codes, group size)
SLOTS = {"Q6_K": (FORM_Q6K, 1, 16), "Q3_K": (FORM_Q6K, 1, 16), "Q4_0": (FORM_QS_NIB, 0, 32),
         "Q4_1": (FORM_QS_NIB, 0, 32), "bf16": (FORM_DENSE, 0, 0)}
CASES = [("v7", s) for s in SLOTS] + [("v6", "Q6_K"), ("v6", "bf16"), ("v5", "Q3_K"),
                                      ("v5", "Q4_1"), ("v4", "Q4_0"), ("v4", "bf16")]
SEEDS = {case: 300 + i for i, case in enumerate(CASES)}


# the cases held against the JAX package's kernels in interpret mode (slow
# on the CPU): each slot form on each whole-stack kernel and body
JAX_CASES = [("v7", "Q3_K"), ("v7", "Q4_0"), ("v7", "bf16"), ("v6", "Q6_K"), ("v5", "Q4_1"),
             ("v4", "bf16")]


@functools.cache
def _model(version, slot):
    kw = dict(n_layer=2, n_emb=256, n_vocab=VOCAB, n_hidden=512, **WIDTHS[version],
              seed=SEEDS[version, slot])
    if slot == "bf16":  # dense matrices load in bf16; V5 and V4 files are f32
        kw.update(dtype=np.float16) if version in ("v7", "v6") else None
    else:
        kw["quantize"] = GgmlDType[slot]
    raw = getattr(synthetic, f"make_{version}_gguf")(**kw)
    return version, slot, raw, load_model(GgufFile(raw), device="cpu")


@pytest.fixture(scope="module", params=CASES, ids=[f"{v}-{s}" for v, s in CASES])
def case(request):
    return _model(*request.param)


@pytest.fixture(scope="module", params=JAX_CASES, ids=[f"{v}-{s}" for v, s in JAX_CASES])
def jax_case(request):
    """A case with the JAX package's model and whole-stack blocks."""
    version, slot, raw, port = _model(*request.param)
    jinfo, jparams = jax_load_model(JaxGgufFile(raw))
    jmega = (jax_prep_decode7 if version == "v7" else jax_prep_decode56)(jparams, jinfo)
    assert jmega is not None
    return version, slot, port, (jinfo, jparams, jmega)


def _mega(version, params, info, B):
    return prepare_decode(params, info, B)["mega7" if version == "v7" else "mega56"]


def _tokens(B, step):
    return (np.arange(B)[:, None] * 5 + 3 + 4 * step) % VOCAB


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_stacks_take_their_slot(case):
    version, slot, _, (info, params) = case
    mega = _mega(version, params, info, 2)
    assert set(mega["forms"].values()) == {descriptor(*SLOTS[slot])}
    if slot == "bf16":
        assert all(ops[0].dtype == torch.bfloat16 and ops[1:] == (None,) * 4
                   for ops in mega["mats"].values())


@pytest.mark.parametrize("B", [1, 5])
def test_layer_scan_matches_jax(jax_case, B):
    """Two decode steps from a zero state, all lanes live (largest errors
    seen: layer 0's ffn_shift 1.5e-4 of max, Q3_K's WKV state 1.7e-5, x
    3.8e-3, every state 6.7e-3)."""
    version, slot, (info, params), (jinfo, jparams, jmega) = jax_case
    mega = _mega(version, params, info, B)
    v7 = version == "v7"
    eps = (LN_EPS, GN_EPS, L2_EPS) if v7 else (LN_EPS, GN_EPS)
    scan, jscan = (layer_scan7, jax_layer_scan7) if v7 else (layer_scan56, jax_layer_scan56)
    st, jst = init_state(info, B, device="cpu"), jax_init_state(jinfo, B)
    pcfg.interpret = True
    try:
        for step in range(2):
            tok = _tokens(B, step)
            x = embed_tokens(params, torch.tensor(tok))[:, 0]
            xo, st = scan(mega, st, x, torch.ones(B), None, *eps)
            jx = jax_embed(jparams, jnp.asarray(tok))[:, 0]
            jxo, jst = jscan(jmega, jst, jx, jnp.ones((B,), jnp.float32), None, *eps)
            assert _rel(xo, jxo) <= OUT_TOL
            for key in jst:
                tol = Q3K_WKV_TOL if (slot, key) == ("Q3_K", "wkv") else LAYER0_TOL[key]
                assert _rel(st[key][0], jst[key][0]) <= tol, (step, key)
                assert _rel(st[key], jst[key]) <= OUT_TOL, (step, key)
    finally:
        pcfg.interpret = False


@pytest.mark.parametrize("B,rescale", [(1, None), (5, 1)])
def test_layer_scan_matches_the_per_layer_path(case, B, rescale):
    """Three steps through ``forward_chunk`` with and without the decode
    blocks; at B=5 lane 2 is frozen on the second step (largest error
    seen: 0)."""
    version, _, _, (info, params) = case
    prepared = prepare_decode(params, info, B)
    assert {"mega7", "mega56"} & set(prepared)
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
        assert _rel(xb[live], xa[live]) <= PER_LAYER_TOL
        for key in st_a:
            assert _rel(st_b[key], st_a[key]) <= PER_LAYER_TOL, key


def test_engine_decodes_through_the_slot(case):
    """The Engine arranges the decode blocks, and its greedy tokens equal
    the per-layer path's: one chunk of prefill, then ``make_generator`` on
    the loaded params."""
    version, _, _, (info, params) = case
    key = "mega7" if version == "v7" else "mega56"
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    assert key in eng.params and key not in params
    prompts = [[5, 9, 11, 2, 7, 8, 1, 0], [3, 1, 4, 1, 5, 9, 2, 6]]
    got = eng.generate(prompts, 6, segment=5)
    st = init_state(info, 2, device="cpu")
    x, st = forward_chunk(info, params, st, torch.tensor(prompts), torch.tensor([8, 8]))
    first = torch.argmax(logits_head(params, x[:, -1]), dim=-1)
    toks, *_ = make_generator(info, steps=5)(params, st, first[:, None])
    assert got == [[int(f)] + t for f, t in zip(first, toks.tolist())]


@pytest.mark.parametrize("version", ["v7", "v6"])
def test_f32_dense_stacks_stay_per_layer(version):
    """The same f16 file loaded with f32 matrices: no slot takes them, and
    ``prepare_decode`` unrolls the blocks instead (the bf16 load takes the
    dense slot)."""
    raw = getattr(synthetic, f"make_{version}_gguf")(
        n_layer=2, n_emb=256, n_vocab=VOCAB, n_hidden=512, **WIDTHS[version],
        dtype=np.float16, seed=399)
    info, params = load_model(GgufFile(raw), dtype=torch.float32, device="cpu")
    assert stack_matrix(params["blocks"]["att"]["Wr"]) is None
    prepared = prepare_decode(params, info, 1)
    assert not {"mega7", "mega56"} & set(prepared) and isinstance(prepared["blocks"], list)
    info16, params16 = load_model(GgufFile(raw), device="cpu")
    assert {"mega7", "mega56"} & set(prepare_decode(params16, info16, 1))


def test_slot_products_match_f64(case):
    """Each slot's product in plain PyTorch (what the kernel row computes)
    against the f64 product of the same bf16 input and dequantized weight
    (largest error seen: 1.5e-7 of max)."""
    version, _, _, (info, params) = case
    mega = _mega(version, params, info, 3)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 512)).astype(np.float32))
    for name, ops in mega["mats"].items():
        desc = mega["forms"][name]
        part, key = name.split(".")
        mat = params["blocks"][part][key]
        for i in range(info.num_layer):
            w = mat.layer(i).dequantize().double()
            xi = x[:, :w.shape[1]]
            want = xi.to(torch.bfloat16).double() @ w.T
            got = slot_gemv_plain(desc, ops, i, xi)
            assert _rel(got, want) <= F64_TOL, (name, i)
