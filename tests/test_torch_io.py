"""The port's ``io`` package and ``load_initial_state`` against the JAX
package's, on the CPU: the reference state layout and state files, model
snapshots (``.rwkvz``), safetensors files, and a file's pretrained
``time_state``.

Widths: 2 layers, C = 64 (head size 16; RWKV-4 C = 64), vocabulary 64.

Bit for bit: the state layouts and state files in both directions, the
snapshot round trip in every matrix kind (params and logits), a JAX-written
snapshot read by the port (params and logits against the port's GGUF
load), ``write_safetensors``' bytes, a safetensors model against the GGUF
load, ``load_initial_state``. The Engine with a file's ``initial_wkv``
against the JAX Engine: f32 dense, rtol = atol = 2e-4 on logits, as
tests/test_torch_runtime.py holds it.
"""

import json
import zipfile

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.io as jax_io
import web_rwkv_gguf_tpu.runtime.scheduler as jax_sched
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.io.safetensors import write_safetensors as jax_write_safetensors
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models.loader import load_initial_state as jax_load_initial_state
from web_rwkv_gguf_tpu.quant.formats import QuantScheme as JaxQuantScheme
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
from web_rwkv_gguf_tpu_torch.gguf import GgufFile, GgufWriter
from web_rwkv_gguf_tpu_torch.io import (
    SafetensorsFile, load_model_snapshot, load_state, save_model, save_state,
    state_from_reference_layout, state_to_reference_layout, write_safetensors)
from web_rwkv_gguf_tpu_torch.models import (
    Matrix, forward_chunk, init_state, load_initial_state, load_model, logits_head,
    params_from_numpy, prepare_decode, unroll_params)
from web_rwkv_gguf_tpu_torch.quant.formats import QuantScheme
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine, RnnInput, RnnInputBatch
from web_rwkv_gguf_tpu_torch.utils import synthetic

F32_TOL = 2e-4
WIDTHS = {
    "v7": dict(n_layer=2, n_emb=64, head_size=16, n_vocab=64, n_hidden=256),
    "v6": dict(n_layer=2, n_emb=64, head_size=16, n_vocab=64, n_hidden=128, rank_tm=8,
               rank_td=8),
    "v5": dict(n_layer=2, n_emb=64, head_size=16, n_vocab=64, n_hidden=128),
    "v4": dict(n_layer=2, n_emb=64, n_vocab=64, n_hidden=128),
}
# snapshot kinds: (make_v7_gguf arguments, load_model quant=)
KINDS = {
    "q4k": (dict(quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K), None),
    "q5k": (dict(quantize=GgmlDType.Q5_K, head_quantize=GgmlDType.Q6_K), None),
    "q8_0": (dict(quantize=GgmlDType.Q8_0), None),
    "int8": (dict(dtype=np.float16), "INT8"),
    "nf4": (dict(dtype=np.float16), "NF4"),
    "f16": (dict(dtype=np.float16), None),
    "f32": (dict(), None),
    "list": (dict(dtype=np.float16), {0: "NF4"}),  # layer 0 NF4, layer 1 dense
}


def _raw(version="v7", seed=41, **kw):
    return getattr(synthetic, f"make_{version}_gguf")(**WIDTHS[version], seed=seed, **kw)


def _quant(q, enum):
    if isinstance(q, dict):
        return {i: enum[s] for i, s in q.items()}
    return None if q is None else enum[q]


def _load(kind, seed=41):
    """A V7 file of ``kind`` loaded by the port on the CPU, and its bytes."""
    kw, q = KINDS[kind]
    raw = _raw(seed=seed, **kw)
    return raw, load_model(GgufFile(raw), quant=_quant(q, QuantScheme), device="cpu")


def _tokens(n, seed, vocab=64):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


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
        assert (mine.dtype, mine.shape) == (ref.dtype, ref.shape), (path, mine.dtype, ref.dtype)
        assert torch.equal(mine, ref), path


def _logits(info, params, tokens=(5, 9, 1, 33, 2)):
    """A prompt's forward and the head on every position, on the CPU."""
    state = init_state(info, 1, device="cpu")
    x, state = forward_chunk(info, params, state, torch.tensor([list(tokens)]),
                             torch.tensor([len(tokens)]))
    return logits_head(params, x[0]), state


# ---------------------------------------------------------------------------
# state layout and files
# ---------------------------------------------------------------------------


def _lane_state(version):
    """Both packages' ModelInfo of a small file, and one lane's state after
    a prompt through the port's Engine."""
    raw = _raw(version, seed=43)
    info, params = load_model(GgufFile(raw), dtype=torch.float32, device="cpu")
    jinfo, _ = jax_load_model(JaxGgufFile(raw))
    eng = Engine(info, params, 2, device="cpu")
    eng.infer(RnnInput([RnnInputBatch(_tokens(9, 1)), RnnInputBatch(_tokens(4, 2))], 32))
    return info, jinfo, eng.back_state(1)


@pytest.mark.parametrize("version", sorted(WIDTHS))
def test_state_layout_matches_jax(version):
    """``state_to_reference_layout`` and back, bit for bit against the JAX
    package's, and the round trip gives the lane's state back."""
    info, jinfo, snap = _lane_state(version)
    ref = state_to_reference_layout(info, snap)
    want = jax_io.state_to_reference_layout(jinfo, snap)
    assert ref.dtype == want.dtype == np.float32 and ref.shape == want.shape
    np.testing.assert_array_equal(ref, want)
    rows = 5 if version == "v4" else info.head_size + 2
    assert ref.shape == (info.num_layer, rows, info.num_emb)
    back, jback = state_from_reference_layout(info, ref), jax_io.state_from_reference_layout(
        jinfo, ref)
    assert sorted(back) == sorted(jback) == sorted(snap)
    for k in snap:
        np.testing.assert_array_equal(back[k], jback[k])
        np.testing.assert_array_equal(back[k], snap[k])
    with pytest.raises(ValueError):
        state_from_reference_layout(info, ref[:, 1:])


@pytest.mark.parametrize("version", sorted(WIDTHS))
def test_state_files_read_both_ways(version, tmp_path):
    """A state file the port writes loads in the JAX package and the
    reverse, bit for bit; both files hold the same members and the same
    ``__state_info__.json``."""
    info, jinfo, snap = _lane_state(version)
    mine, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    save_state(mine, info, snap)
    jax_io.save_state(theirs, jinfo, snap)
    for loaded in (jax_io.load_state(mine), load_state(theirs), load_state(mine)):
        assert sorted(loaded) == sorted(snap)
        for k in snap:
            assert loaded[k].dtype == snap[k].dtype
            np.testing.assert_array_equal(loaded[k], snap[k])
    with zipfile.ZipFile(mine) as a, zipfile.ZipFile(theirs) as b:
        assert a.namelist() == b.namelist()
        assert json.loads(a.read("__state_info__.json")) == json.loads(
            b.read("__state_info__.json"))


# ---------------------------------------------------------------------------
# model snapshots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_snapshot_round_trip(kind, tmp_path):
    """``save_model`` → ``load_model_snapshot``: the same ModelInfo, every
    array equal bit for bit (values, dtype, shape; list blocks as lists),
    nothing requantized, and the same logits bit for bit."""
    _, (info, params) = _load(kind)
    path = tmp_path / "model.rwkvz"
    save_model(path, info, params)
    info2, params2 = load_model_snapshot(path, device="cpu")
    assert info2 == info
    _assert_same_tree(params2, params)
    if kind == "list":
        assert isinstance(params2["blocks"], list)
    got, st = _logits(info2, params2)
    want, st0 = _logits(info, params)
    assert torch.equal(got, want)
    for k in st0:
        assert torch.equal(st[k], st0[k])


def test_snapshot_leaves_out_the_decode_blocks(tmp_path):
    """Prepared params (whole-stack blocks) and unrolled ones (grouped
    r/k/v operands) save without them: the snapshot holds the loaded
    params, and ``prepare_decode`` rebuilds the blocks from it."""
    raw = synthetic.make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=64,
                                 n_hidden=256, quantize=GgmlDType.Q4_K, seed=44)
    info, params = load_model(GgufFile(raw), device="cpu")
    for form in (prepare_decode(params, info, 4), unroll_params(params)):
        path = tmp_path / "model.rwkvz"
        save_model(path, info, form)
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        assert not any(s in n for n in names for s in ("mega7", "Wrkv_g"))
        _, back = load_model_snapshot(path, device="cpu")
        if isinstance(form["blocks"], list):
            assert all("Wrkv_g" not in blk["att"] for blk in back["blocks"])
        else:
            _assert_same_tree(back, params)
            assert "mega7" in prepare_decode(back, info, 4)


@pytest.mark.parametrize("kind", ["q4k", "q8_0", "int8", "nf4", "f16"])
def test_jax_snapshot_loads_in_the_port(kind, tmp_path):
    """A ``.rwkvz`` the JAX package wrote (with its TPU operands, bf16 as
    uint16) loads in the port through ``params_from_numpy``'s key filter:
    every array equal bit for bit to the port's own load of the GGUF file,
    and the same logits bit for bit."""
    raw, (info, params) = _load(kind)
    q = KINDS[kind][1]
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), quant=_quant(q, JaxQuantScheme))
    path = tmp_path / "jax.rwkvz"
    jax_io.save_model(path, jinfo, jparams)
    info2, params2 = load_model_snapshot(path, device="cpu")
    assert info2 == info
    _assert_same_tree(params2, params)
    _assert_same_tree(params2, params_from_numpy(jax.device_get(jparams), device="cpu"))
    got, _ = _logits(info2, params2)
    want, _ = _logits(info, params)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


def _st_dict(rng):
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float16),
            "c": rng.normal(size=(4, 8)).astype(ml_dtypes.bfloat16)}


def test_write_safetensors_bytes_match_jax(tmp_path):
    """f32, f16 and bf16 tensors (bf16 as a torch tensor or a numpy bf16
    array) write the JAX package's bytes; each package reads the other's
    file to the same values."""
    arrays = _st_dict(np.random.default_rng(3))
    jax_write_safetensors(tmp_path / "jax.st", arrays)
    as_torch = {**arrays, "c": torch.from_numpy(arrays["c"].view(np.int16)).view(
        torch.bfloat16)}
    write_safetensors(tmp_path / "port.st", as_torch)
    write_safetensors(tmp_path / "port_np.st", arrays)
    want = (tmp_path / "jax.st").read_bytes()
    assert (tmp_path / "port.st").read_bytes() == want
    assert (tmp_path / "port_np.st").read_bytes() == want
    mine, theirs = SafetensorsFile(tmp_path / "port.st"), jax_io.SafetensorsFile(
        tmp_path / "jax.st")
    assert mine.names() == theirs.names() == ["a", "b", "c"]
    for name in arrays:
        assert mine.shape(name) == theirs.shape(name)
        for dtype in (np.float32, np.float16):
            np.testing.assert_array_equal(mine.tensor(name, dtype), theirs.tensor(name, dtype))
    np.testing.assert_array_equal(mine.tensor("c", np.float32),
                                  arrays["c"].astype(np.float32))
    assert mine.quantized_tensor("a") is None and not mine.contains("d")
    assert SafetensorsFile(want).tensor("b", np.float32).dtype == np.float32


def _model_convention(reader, bf16=False):
    """The model-convention tensors of a GGUF file in their stored type
    (f16 or f32), or all as bf16."""
    out = {}
    for name in reader.names():
        if not reader.contains(name) or not (
                name.startswith("blocks.") or name.split(".")[0] in ("emb", "ln_out", "head")):
            continue
        stored = reader.tensors[reader.name_map[name]].dtype if name in reader.name_map else None
        a = reader.tensor(name, np.float16 if stored == GgmlDType.F16 else np.float32)
        out[name] = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) if bf16 else a
    return out


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
def test_safetensors_model_loads_as_the_gguf(dtype, tmp_path):
    """A model written as a model-convention ``.safetensors`` file loads with
    ``load_model(SafetensorsFile(...))``, as the JAX package's test_io.py
    loads one: f32 and f16 tensors stored as the GGUF stores them give the
    GGUF load's params and logits bit for bit; a bf16 file gives the JAX
    package's load of the same file bit for bit."""
    raw = _raw(seed=45, **({"dtype": np.float16} if dtype == "f16" else {}))
    g = GgufFile(raw)
    path = tmp_path / "model.st"
    write_safetensors(path, _model_convention(g, bf16=dtype == "bf16"))
    info, params = load_model(SafetensorsFile(path), device="cpu")
    jinfo, jparams = jax_load_model(jax_io.SafetensorsFile(path))
    _assert_same_tree(params, params_from_numpy(jax.device_get(jparams), device="cpu"))
    if dtype == "bf16":
        return
    ginfo, gparams = load_model(g, device="cpu")
    assert info == ginfo
    _assert_same_tree(params, gparams)
    assert torch.equal(_logits(info, params)[0], _logits(ginfo, gparams)[0])


# ---------------------------------------------------------------------------
# a file's time_state
# ---------------------------------------------------------------------------


def _time_state_file(info, seed=5):
    """A GGUF file holding each layer's ``time_state`` ([H·V, K]) alone."""
    rng = np.random.default_rng(seed)
    w = GgufWriter()
    w.add_metadata("rwkv7.wkv.head_size", info.head_size)
    states = [rng.normal(size=(info.num_emb, info.head_size)).astype(np.float32)
              for _ in range(info.num_layer)]
    for i, st in enumerate(states):
        w.add_tensor(f"blk.{i}.attn_time_state", st)
    return w.tobytes(), states


def test_load_initial_state_matches_jax():
    """``[L, H, K, V]``, bit for bit as the JAX package's, and element by
    element stored[h·hs + v, k] == wkv[layer, h, k, v]."""
    info, _ = load_model(GgufFile(_raw()), device="cpu")
    raw, states = _time_state_file(info)
    wkv = load_initial_state(GgufFile(raw), info)
    jinfo, _ = jax_load_model(JaxGgufFile(_raw()))
    np.testing.assert_array_equal(wkv, jax_load_initial_state(JaxGgufFile(raw), jinfo))
    H, hs = info.num_head, info.head_size
    assert wkv.shape == (info.num_layer, H, hs, hs) and wkv.dtype == np.float32
    for i, st in enumerate(states):
        np.testing.assert_array_equal(wkv[i], st.reshape(H, hs, hs).transpose(0, 2, 1))


def test_engine_initial_wkv_from_a_file_matches_jax():
    """``Engine(initial_wkv=load_initial_state(...))``: every lane starts
    from the file's state, a reset lane returns to it, and a prompt's
    logits and state match the JAX Engine given the same array (largest
    errors seen: 7.7e-7 of max|logit|, 8.9e-7 of max|state|)."""
    raw = _raw(seed=46)
    info, params = load_model(GgufFile(raw), dtype=torch.float32, device="cpu")
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), dtype=np.float32)
    wkv = load_initial_state(GgufFile(_time_state_file(info)[0]), info)
    eng = Engine(info, params, 2, initial_wkv=wkv, device="cpu")
    jeng = JaxEngine(jinfo, jparams, 2, initial_wkv=wkv)
    for b in range(2):
        np.testing.assert_array_equal(eng.back_state(b)["wkv"], wkv)
    prompts = [_tokens(9, 3), _tokens(5, 4)]
    out = eng.infer(RnnInput([RnnInputBatch(list(p)) for p in prompts], 32))
    jout = jeng.infer(jax_sched.RnnInput([jax_sched.RnnInputBatch(list(p)) for p in prompts],
                                         32))
    for o, jo in zip(out, jout):
        np.testing.assert_allclose(o, np.asarray(jo), rtol=F32_TOL, atol=F32_TOL)
    for b in range(2):
        for key, want in jeng.back_state(b).items():
            np.testing.assert_allclose(eng.back_state(b)[key], want, rtol=0,
                                       atol=F32_TOL * np.abs(want).max())
    eng.reset_state(0)
    np.testing.assert_array_equal(eng.back_state(0)["wkv"], wkv)
    assert not np.array_equal(eng.back_state(1)["wkv"], wkv)
