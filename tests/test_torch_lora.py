"""LoRA merge at load (``load_model(lora=)``, ``LoraPatch``) and the
direct-load switch (``GgufFile(allow_quantized_direct=)``) of the port
against the JAX package's, on the CPU. Every model and LoRA file is built
here from a seed (``make_v*_gguf``, ``io.write_safetensors``), and both
packages read the same bytes.

Tolerances: logical weights, logits and state on f32 loads, rtol = atol =
2e-4; on quantized loads (NF4 requant, Q4_K_M), 3e-2·max|JAX| (the JAX
CPU path rounds quantized weights to bf16; ROADMAP "Tolerances in
force"); a merge against its numpy formula, the f16 round trip the loader
applies, atol = 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.io.safetensors import SafetensorsFile as JaxSafetensorsFile
from web_rwkv_gguf_tpu.models import forward_chunk as jax_forward_chunk
from web_rwkv_gguf_tpu.models import init_state as jax_init_state
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models import logits_head as jax_logits_head
from web_rwkv_gguf_tpu.models.loader import LoraPatch as JaxLoraPatch
from web_rwkv_gguf_tpu.models.loader import _layer_slice as jax_layer_slice
from web_rwkv_gguf_tpu.quant.formats import QuantScheme as JaxQuantScheme
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.io import SafetensorsFile, write_safetensors
from web_rwkv_gguf_tpu_torch.models import (
    Matrix, forward_chunk, init_state, load_model, logits_head,
)
from web_rwkv_gguf_tpu_torch.models.loader import LoraPatch, layer_params
from web_rwkv_gguf_tpu_torch.quant import QuantScheme
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v4_gguf, make_v5_gguf, make_v7_gguf

F32_TOL = 2e-4
QUANT_TOL = 3e-2
MERGE_TOL = 1e-6
TOKENS = [[3, 17, 40, 8], [9, 1, 25, 33]]
V7_MATRICES = [f"att.{m}.weight" for m in ("key", "value", "receptance", "output")] + [
    f"ffn.{m}.weight" for m in ("key", "value")]


def _f32_raw():
    return make_v7_gguf(n_layer=2, n_emb=32, head_size=8, n_vocab=48, seed=70)


def _lora_tensors(reader, layers, rank, seed, vectors=(), adapters=()):
    """A LoRA's tensors for ``reader``'s model: an (A, B) pair of ``rank``
    for every V7 layer matrix of ``layers`` and for each adapter name in
    ``adapters``, and a vector for each name in ``vectors``."""
    rng = np.random.default_rng(seed)
    out = {}
    names = [f"blocks.{i}.{m}" for i in layers for m in V7_MATRICES] + list(adapters)
    for name in names:
        m, k = reader.tensor(name, np.float32).shape
        out[f"{name}.lora.0"] = (rng.normal(size=(rank, k)) * 0.1).astype(np.float32)
        out[f"{name}.lora.1"] = (rng.normal(size=(m, rank)) * 0.1).astype(np.float32)
    for name in vectors:
        out[name] = rng.normal(size=reader.tensor(name, np.float32).size).astype(np.float32)
    return out


def _patches(tmp_path, tensors, blend):
    path = tmp_path / "lora.st"
    write_safetensors(path, tensors)
    return [LoraPatch(SafetensorsFile(path), blend)], [JaxLoraPatch(JaxSafetensorsFile(path),
                                                                     blend)]


def _mat_np(mat):
    return (mat.dequantize() if isinstance(mat, Matrix) else mat).float().numpy()


def _jax_mat_np(mat):
    return np.asarray(mat.dequantize(jnp.float32), np.float32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _close_to_max(got, want, rel=QUANT_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _logits(info, params, jinfo, jparams):
    """Both packages' last-row logits and state after a T=4 chunk of two
    lanes."""
    lens = [4, 4]
    x, st = forward_chunk(info, params, init_state(info, 2, device="cpu"),
                          torch.tensor(TOKENS), torch.tensor(lens))
    jx, jst = jax_forward_chunk(jinfo, jparams, jax_init_state(jinfo, 2),
                                jnp.asarray(TOKENS, jnp.int32), jnp.asarray(lens, jnp.int32))
    return ((logits_head(params, x[:, -1]).numpy(), {k: v.numpy() for k, v in st.items()}),
            (np.asarray(jax_logits_head(jparams, jx[:, -1])),
             {k: np.asarray(v) for k, v in jst.items()}))


def _layer_mats(params, jparams, L):
    """Every layer matrix of both packages' params: (name, port, JAX)."""
    port = layer_params(params, L)
    jblocks = jparams["blocks"]
    for i in range(L):
        jb = jblocks[i] if isinstance(jblocks, list) else jax_layer_slice(jblocks, i)
        for part, keys in (("att", ("Wk", "Wv", "Wr", "Wo")), ("ffn", ("Wk", "Wv"))):
            for key in keys:
                yield f"{i}.{part}.{key}", port[i][part][key], jb[part][key]


@pytest.mark.parametrize("helper, args", [
    ("blend_full", (0.4,)), ("blend_nominal", (0.3,)), ("blend_matrices", (2.0,)),
    ("blend_layer_nominal", (1, 0.5)), ("blend_layer_matrices", (0, 0.7)),
])
def test_blend_helpers_match_jax(helper, args):
    assert getattr(LoraPatch, helper)(*args) == getattr(JaxLoraPatch, helper)(*args)


def test_full_patch_is_the_jax_full_patch():
    assert LoraPatch.full(None, 0.6).blend == JaxLoraPatch.full(None, 0.6).blend
    assert LoraPatch.MATRIX_PATTERN == JaxLoraPatch.MATRIX_PATTERN


def test_vector_blend(tmp_path):
    """x ← α·lora + (1 − α)·x where the pattern matches; other vectors
    are untouched; the six-mix stack follows."""
    raw = _f32_raw()
    base = GgufFile(raw)
    orig = base.tensor("blocks.0.att.x_r", np.float32)
    lora_vec = np.full_like(orig, 0.25)
    port, jax_ = _patches(tmp_path, {"blocks.0.att.x_r": lora_vec}, [(r"x_r$", 0.5)])
    _, params = load_model(GgufFile(raw), lora=port, dtype=torch.float32, device="cpu")
    _, jparams = jax_load_model(JaxGgufFile(raw), lora=jax_, dtype=jnp.float32)
    att = params["blocks"]["att"]
    np.testing.assert_allclose(att["x_r"][0].numpy(), 0.5 * lora_vec + 0.5 * orig,
                               rtol=0, atol=MERGE_TOL)
    np.testing.assert_array_equal(att["x_r"][0].numpy(),
                                  np.asarray(jparams["blocks"]["att"]["x_r"][0]))
    np.testing.assert_array_equal(att["x_stack"][0, 0].numpy(), att["x_r"][0].numpy())
    np.testing.assert_array_equal(att["x_w"][0].numpy(),
                                  base.tensor("blocks.0.att.x_w", np.float32))


@pytest.mark.parametrize("order", ["specific_last", "general_last"])
def test_last_matching_pattern_wins(tmp_path, order):
    raw = _f32_raw()
    base = GgufFile(raw)
    names = ("blocks.1.att.x_r", "blocks.1.att.x_w")
    tensors = {n: np.full(32, 2.0, np.float32) for n in names}
    blend = [(r".+", 0.2), (r"x_r$", 0.7)]
    if order == "general_last":
        blend = blend[::-1]
    port, jax_ = _patches(tmp_path, tensors, blend)
    _, params = load_model(GgufFile(raw), lora=port, dtype=torch.float32, device="cpu")
    _, jparams = jax_load_model(JaxGgufFile(raw), lora=jax_, dtype=jnp.float32)
    a_r = 0.7 if order == "specific_last" else 0.2
    for name, alpha in zip(names, (a_r, 0.2)):
        key = name.rsplit(".", 1)[1]
        want = alpha * 2.0 + (1 - alpha) * base.tensor(name, np.float32)
        got = params["blocks"]["att"][key][1].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=MERGE_TOL)
        np.testing.assert_array_equal(got, np.asarray(jparams["blocks"]["att"][key][1]))


@pytest.mark.parametrize("ver", ["v5", "v4"])
def test_decay_blends_before_its_activation(tmp_path, ver):
    """V5's decay is exp(−exp(blend)) and V4's −exp(blend): the LoRA
    vector blends into the raw decay, as the JAX loader does."""
    make = make_v5_gguf if ver == "v5" else make_v4_gguf
    kw = {"head_size": 8} if ver == "v5" else {}
    raw = make(n_layer=2, n_emb=32, n_vocab=48, seed=72, **kw)
    base = GgufFile(raw)
    name = "blocks.1.att.time_decay"
    lora_vec = np.random.default_rng(73).normal(size=32).astype(np.float32)
    port, jax_ = _patches(tmp_path, {name: lora_vec}, [(r"time_decay", 0.6)])
    _, params = load_model(GgufFile(raw), lora=port, dtype=torch.float32, device="cpu")
    _, jparams = jax_load_model(JaxGgufFile(raw), lora=jax_, dtype=jnp.float32)
    raw_w = 0.6 * lora_vec + 0.4 * base.tensor(name, np.float32).reshape(-1)
    want = np.exp(-np.exp(raw_w)) if ver == "v5" else -np.exp(raw_w)
    got = params["blocks"]["att"]["time_decay"][1].numpy().reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=MERGE_TOL)
    _close(got, np.asarray(jparams["blocks"]["att"]["time_decay"][1]).reshape(-1))


def test_matrix_blend(tmp_path):
    """W ← W + α/rank·B@A, then the f16 round trip: one layer's key
    matrix against numpy and the JAX package's; the other layer's and
    the other matrices are untouched."""
    raw = _f32_raw()
    base = GgufFile(raw)
    name = "blocks.0.att.key.weight"
    w = base.tensor(name, np.float32).reshape(32, 32)
    rng = np.random.default_rng(74)
    a = rng.normal(size=(2, 32)).astype(np.float32)
    b = rng.normal(size=(32, 2)).astype(np.float32)
    port, jax_ = _patches(tmp_path, {f"{name}.lora.0": a, f"{name}.lora.1": b},
                          [(r"key", 8.0)])
    info, params = load_model(GgufFile(raw), lora=port, dtype=torch.float32, device="cpu")
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), lora=jax_, dtype=jnp.float32)
    want = (w + 4.0 * (b @ a)).astype(np.float16).astype(np.float32)
    got = _mat_np(params["blocks"]["att"]["Wk"].layer(0))
    np.testing.assert_allclose(got, want, rtol=0, atol=MERGE_TOL)
    for key, mat, jmat in _layer_mats(params, jparams, 2):
        np.testing.assert_array_equal(_mat_np(mat), _jax_mat_np(jmat), err_msg=key)


@pytest.fixture(scope="module")
def full_lora(tmp_path_factory):
    """The f32 file and a rank-4 LoRA on every layer matrix, one inner
    adapter and two vectors, merged by both packages."""
    raw = _f32_raw()
    tensors = _lora_tensors(GgufFile(raw), range(2), 4, 75,
                            vectors=("blocks.1.att.x_k", "blocks.0.ln1.weight"),
                            adapters=("blocks.1.att.a1",))
    path = tmp_path_factory.mktemp("lora") / "lora.st"
    write_safetensors(path, tensors)
    blend = LoraPatch.blend_nominal(0.5) + LoraPatch.blend_matrices(0.75)
    return raw, path, blend


def test_full_lora_matches_jax(full_lora):
    """Every merged layer matrix, the merged adapter and vectors, the
    logits and the state, against the JAX package's merge (f32)."""
    raw, path, blend = full_lora
    info, params = load_model(GgufFile(raw), lora=[LoraPatch(SafetensorsFile(path), blend)],
                              dtype=torch.float32, device="cpu")
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), lora=[JaxLoraPatch(
        JaxSafetensorsFile(path), blend)], dtype=jnp.float32)
    _, plain = load_model(GgufFile(raw), dtype=torch.float32, device="cpu")
    for key, mat, jmat in _layer_mats(params, jparams, 2):
        _close(_mat_np(mat), _jax_mat_np(jmat))
    att, jatt = params["blocks"]["att"], jparams["blocks"]["att"]
    for key in ("a1", "x_k"):
        _close(att[key].numpy(), np.asarray(jatt[key]))
    assert not torch.equal(att["a1"][1], plain["blocks"]["att"]["a1"][1])
    _close(params["blocks"]["ln1"]["w"].numpy(), np.asarray(jparams["blocks"]["ln1"]["w"]))
    (lg, st), (jlg, jst) = _logits(info, params, jinfo, jparams)
    _close(lg, jlg)
    for key in jst:
        _close(st[key], jst[key])


def test_lora_with_nf4_matches_jax(tmp_path):
    """A rank-4 LoRA on every layer matrix of an f16 file, loaded with
    ``quant=NF4``: the merged matrices requantize to NF4 (the merge
    happens before the f16 round trip and the scheme), and their logical
    weights and the logits match the JAX package's."""
    raw = make_v7_gguf(n_layer=2, n_emb=64, head_size=8, n_vocab=48, seed=76,
                       dtype=np.float16)
    tensors = _lora_tensors(GgufFile(raw), range(2), 4, 77, vectors=("blocks.0.att.x_v",))
    port, jax_ = _patches(tmp_path, tensors, LoraPatch.full(None, 0.5).blend)
    info, params = load_model(GgufFile(raw), quant=QuantScheme.NF4, lora=port, device="cpu")
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), quant=JaxQuantScheme.NF4, lora=jax_)
    kinds = set()
    for key, mat, jmat in _layer_mats(params, jparams, 2):
        kinds.add(mat.kind)
        _close_to_max(_mat_np(mat), _jax_mat_np(jmat))
    assert kinds == {"nf4"}
    (lg, st), (jlg, _) = _logits(info, params, jinfo, jparams)
    _close_to_max(lg, jlg)


@pytest.fixture(scope="module")
def q4km_raw():
    return make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                        quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K, seed=78)


def test_layer0_lora_on_q4km_loads_per_layer(tmp_path, q4km_raw):
    """A LoRA on layer 0's matrices of a Q4_K_M file: layer 0 loads dense
    (merged, never direct-quantized), layer 1 keeps its Q4_K blocks, so the
    blocks load as per-layer lists, as the JAX package's do; logical
    weights and logits against the JAX package's."""
    blend = LoraPatch.blend_layer_matrices(0, 1.0)
    tensors = _lora_tensors(GgufFile(q4km_raw), [0], 8, 79)
    port, jax_ = _patches(tmp_path, tensors, blend)
    info, params = load_model(GgufFile(q4km_raw), lora=port, device="cpu")
    jinfo, jparams = jax_load_model(JaxGgufFile(q4km_raw), lora=jax_)
    assert isinstance(params["blocks"], list) and isinstance(jparams["blocks"], list)
    assert params["blocks"][0]["att"]["Wk"].kind == "dense"
    assert params["blocks"][1]["att"]["Wk"].kind == jparams["blocks"][1]["att"]["Wk"].kind
    for key, mat, jmat in _layer_mats(params, jparams, 2):
        _close_to_max(_mat_np(mat), _jax_mat_np(jmat))
    (lg, _), (jlg, _) = _logits(info, params, jinfo, jparams)
    _close_to_max(lg, jlg)


def test_allow_quantized_direct_false_matches_jax(q4km_raw):
    """``GgufFile(allow_quantized_direct=False)``: no tensor comes back
    quantized, every matrix loads dense through dequantization (the head
    too), and the f32 load matches the JAX package's with the same flag."""
    reader = GgufFile(q4km_raw, allow_quantized_direct=False)
    assert reader.quantized_tensor("blocks.0.att.key.weight") is None
    assert GgufFile(q4km_raw).quantized_tensor("blocks.0.att.key.weight") is not None
    info, params = load_model(reader, dtype=torch.float32, device="cpu")
    jinfo, jparams = jax_load_model(JaxGgufFile(q4km_raw, allow_quantized_direct=False),
                                    dtype=jnp.float32)
    assert params["head"].kind == "dense"
    for key, mat, jmat in _layer_mats(params, jparams, 2):
        assert mat.kind == "dense", key
        _close(_mat_np(mat), _jax_mat_np(jmat))
    (lg, st), (jlg, jst) = _logits(info, params, jinfo, jparams)
    _close_to_max(lg, jlg, F32_TOL)
    for key in jst:
        _close_to_max(st[key], jst[key], F32_TOL)
