"""The port's GGUF writer, reader and loader against the JAX package's, on
the CPU: same file bytes, same tensors, same parameter tree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.quant.ggml import GgmlDType as JaxGgmlDType
from web_rwkv_gguf_tpu.utils.synthetic import make_v7_gguf as jax_make_v7_gguf
from web_rwkv_gguf_tpu_torch.errors import InvalidVersion
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import Matrix, load_model, params_from_numpy
from web_rwkv_gguf_tpu_torch.quant import ggml, repack
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

# Q4_K_M at a width whose rows hold whole 256-element super-blocks
Q4KM = dict(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024)

FILES = {
    "f32": dict(seed=3),
    "fused_lerp": dict(seed=4, fused_lerp=True),
    "f16": dict(seed=5, dtype=np.float16),
    "q4k": dict(n_layer=2, n_emb=256, head_size=64, n_vocab=256, seed=6,
                quantize="Q4_K"),
}


def _kw(kw, dtype_enum):
    kw = dict(kw)
    if "quantize" in kw:
        kw["quantize"] = dtype_enum[kw["quantize"]]
    return kw


@pytest.mark.parametrize("name", sorted(FILES))
def test_writer_bytes_match_jax(name):
    kw = FILES[name]
    assert make_v7_gguf(**_kw(kw, GgmlDType)) == jax_make_v7_gguf(**_kw(kw, JaxGgmlDType))


def test_head_quantize_changes_only_the_head():
    """``head_quantize`` writes the Q4_K_M placement; the other tensors
    are the same bytes as the plain Q4_K file of the same seed."""
    a = GgufFile(make_v7_gguf(**Q4KM, quantize=GgmlDType.Q4_K, seed=1))
    b = GgufFile(make_v7_gguf(**Q4KM, quantize=GgmlDType.Q4_K,
                              head_quantize=GgmlDType.Q6_K, seed=1))
    assert b.tensors["output.weight"].dtype == GgmlDType.Q6_K
    assert a.tensors["output.weight"].dtype == GgmlDType.Q4_K
    for gname, info in a.tensors.items():
        if gname != "output.weight":
            assert b.tensors[gname].dtype == info.dtype
            assert np.array_equal(a._raw(info), b._raw(b.tensors[gname]))


@pytest.mark.parametrize("name", sorted(FILES))
def test_reader_matches_jax(name):
    raw = make_v7_gguf(**_kw(FILES[name], GgmlDType))
    mine, ref = GgufFile(raw), JaxGgufFile(raw)
    assert mine.names() == ref.names()
    assert mine.metadata == ref.metadata
    for n in ref.names():
        assert mine.shape(n) == ref.shape(n)
        np.testing.assert_array_equal(mine.tensor(n, np.float32),
                                      ref.tensor(n, np.float32))


def test_quant_round_trip_matches_jax():
    """Port dequantizers and repackers give the JAX package's numbers."""
    from web_rwkv_gguf_tpu.quant import ggml as jg
    from web_rwkv_gguf_tpu.quant import repack as jr

    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 512)).astype(np.float32)
    for q, dq, jdq in ((ggml.quantize_q4_k, ggml.dequantize_q4_k, jg.dequantize_q4_k),
                       (ggml.quantize_q6_k, ggml.dequantize_q6_k, jg.dequantize_q6_k)):
        raw = q(w)
        np.testing.assert_array_equal(dq(raw, w.size), jdq(raw, w.size))
    raw4 = np.frombuffer(ggml.quantize_q4_k(w), np.uint8)
    for a, b in zip(repack.q4k_scale_factors(raw4, 8, 512),
                    jr.q4k_scale_factors(raw4, 8, 512)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(repack.repack_q4_k(raw4, 8, 512)[0],
                                  jr.repack_q4_k(raw4, 8, 512)[0])
    raw6 = np.frombuffer(ggml.quantize_q6_k(w), np.uint8)
    for a, b in zip(repack.q6k_scale_factors(raw6, 8, 512),
                    jr.q6k_scale_factors(raw6, 8, 512)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(repack.repack_q6_k(raw6, 8, 512)[0],
                                  jr.repack_q6_k(raw6, 8, 512)[0])


def _assert_same_tree(mine, ref, path="params"):
    if isinstance(ref, dict):
        assert set(mine) == set(ref), (path, set(mine) ^ set(ref))
        for k in ref:
            _assert_same_tree(mine[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(mine, list) and len(mine) == len(ref), path
        for i, (a, b) in enumerate(zip(mine, ref)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(ref, Matrix):
        assert isinstance(mine, Matrix), path
        assert (mine.kind, mine.shape) == (ref.kind, ref.shape), path
        _assert_same_tree(mine.arrays, ref.arrays, path)
    else:
        assert mine.dtype == ref.dtype, (path, mine.dtype, ref.dtype)
        assert mine.shape == ref.shape, (path, mine.shape, ref.shape)
        assert torch.equal(mine, ref), path


LOADS = {
    "f32_dense": (dict(seed=7), dict(dtype=jnp.float32), dict(dtype=torch.float32)),
    "q4km": (dict(**Q4KM, seed=8, quantize=GgmlDType.Q4_K,
                  head_quantize=GgmlDType.Q6_K), {}, {}),
    "f32_fused_rescale": (dict(seed=9, n_layer=3, fused_lerp=True),
                          dict(dtype=jnp.float32, rescale=2),
                          dict(dtype=torch.float32, rescale=2)),
}


@pytest.mark.parametrize("name", sorted(LOADS))
def test_load_model_matches_jax(name):
    """The port's load_model == params_from_numpy(JAX load_model) exactly,
    on the same bytes: every array (values, dtype, shape) and ModelInfo."""
    file_kw, jax_kw, port_kw = LOADS[name]
    raw = make_v7_gguf(**file_kw)
    info, params = load_model(GgufFile(raw), device="cpu", **port_kw)
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), **jax_kw)
    carried = params_from_numpy(jax.device_get(jparams), device="cpu")
    _assert_same_tree(params, carried)
    mine, ref = dataclasses.asdict(info), dataclasses.asdict(jinfo)
    mine["version"], ref["version"] = mine["version"].value, ref["version"].value
    assert mine == ref
    if name == "q4km":
        assert params["head"].kind == "qk_nomin"
        assert sorted(params["head"].arrays) == ["codes", "q6d", "q6s"]
        assert params["blocks"]["att"]["Wk"].kind == "qk"
        assert sorted(params["blocks"]["att"]["Wk"].arrays) == [
            "codes", "d8", "dm8", "mn6", "sc6"]


def test_params_from_numpy_drops_tpu_layouts():
    class M:  # duck-typed matrix, as the JAX package's
        kind, shape = "qk_nomin", (4, 256)
        arrays = {"codes": np.zeros((4, 256), np.int8),
                  "q6s": np.zeros((4, 16), np.int8),
                  "q6d": np.zeros((4, 1), np.float32),
                  "scq": np.zeros((16, 4), np.int8),
                  "sdn": np.zeros((1, 4), np.float32)}

    out = params_from_numpy({"head": M(), "mega7": {"x": np.zeros(3)},
                             "blocks": [{"v": np.ones(2, np.float32)}]},
                            device="cpu")
    assert set(out) == {"head", "blocks"}
    assert sorted(out["head"].arrays) == ["codes", "q6d", "q6s"]
    assert torch.equal(out["blocks"][0]["v"], torch.ones(2))


def test_mixed_layer_kinds_load_per_layer():
    """Layers whose matrices differ in kind load as a per-layer list (as
    a llama.cpp Q4_K_M file keeps some layers' matrices in Q6_K)."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufWriter

    src = GgufFile(make_v7_gguf(**Q4KM, quantize=GgmlDType.Q4_K, seed=2))
    w = GgufWriter()
    for k, v in src.metadata.items():
        if k != "general.alignment":
            w.add_metadata(k, v)
    for gname, info in src.tensors.items():
        if gname == "blk.1.channel_mix_value.weight":
            w.add_tensor(gname, src.tensor("blocks.1.ffn.value.weight", np.float32),
                         quantize=GgmlDType.Q6_K)
        else:
            w.add_raw_tensor(gname, info.dims, info.dtype, bytes(src._raw(info)))
    info, params = load_model(GgufFile(w.tobytes()), device="cpu")
    assert isinstance(params["blocks"], list) and len(params["blocks"]) == 2
    assert params["blocks"][0]["ffn"]["Wv"].kind == "qk"
    assert params["blocks"][1]["ffn"]["Wv"].kind == "qk_nomin"


def test_loader_refuses_other_versions():
    """Every RWKV version the JAX package loads (V4-V7) loads; a file whose
    tensors name no version is refused with a typed error."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufWriter

    w = GgufWriter()
    w.add_tensor("token_embd.weight", np.zeros((8, 16), np.float32))
    w.add_tensor("blk.0.ffn_k.weight", np.zeros((64, 16), np.float32))
    with pytest.raises(InvalidVersion):
        load_model(GgufFile(w.tobytes()), device="cpu")
