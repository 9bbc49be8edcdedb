"""The port's pipelined whole-stack decode (``parallel/decode_pp.py``) on
the CPU: two gloo ranks, one pipeline stage each, every stage holding only
its own layers.

One spawn (``parallel/launch.py``: a ``file://`` rendezvous, a 60 s
collective timeout, a 120 s deadline) runs every case on both stages for
an RWKV-7 model (``layer_scan7`` with ``v0_carry``) and an RWKV-4 one
(``layer_scan56`` with ``first_layer``), both L = 4, C = 256, Q4_K with a
Q6_K head (the whole-stack kernels take head size 64 and widths in
multiples of 256), G = 2 groups of B = 2 lanes:

- ``PipelinedDecoder.generate`` for 8 steps, twice (the state carried),
  against the port's single-rank ``greedy_scan_reference`` over 16 steps
  per group: tokens and final state bit for bit (the plain versions of
  the stage slices compose exactly: tests/test_torch_decode.py);
- the functional form (``make_pp_params``, ``pp_state``,
  ``make_pp_generator``), likewise;
- one step from given tokens, twice, against the JAX package's
  ``PipelinedDecoder`` on a ``pp`` axis of 2 (its kernels in interpret
  mode): the carried state at 3e-2·max (a quantized model; tokens are
  not compared across the two numerics classes).

The ranks import no JAX: this module imports it only inside the parent's
functions.
"""

import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu_torch.errors import EngineError
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import load_model, prepare_decode
from web_rwkv_gguf_tpu_torch.parallel import (
    Mesh, PipelinedDecoder, greedy_scan_reference, make_pp_generator, make_pp_params, pp_state)
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType

G, B, STEPS = 2, 2, 8
QUANT_TOL = 3e-2
Q = dict(quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K)
MODELS = {
    "v7": ("make_v7_gguf", dict(n_layer=4, n_emb=256, head_size=64, n_vocab=64,
                                n_hidden=512, seed=61, **Q)),
    "v4": ("make_v4_gguf", dict(n_layer=4, n_emb=256, n_vocab=64, n_hidden=512, seed=62,
                                **Q)),
}
TOKEN0 = (np.arange(G * B).reshape(G, B) * 7 + 1) % 64
# the teacher-forced steps of the comparison with the JAX package
FORCED = ((np.arange(G * B).reshape(G, B) * 5 + 3) % 64,
          (np.arange(G * B).reshape(G, B) * 3 + 11) % 64)


def _model(workdir, name):
    return load_model(GgufFile(open(f"{workdir}/{name}.gguf", "rb").read()), device="cpu")


def _np_state(state):
    return {k: v.numpy().copy() for k, v in state.items()}


def rank_main(rank, world, workdir):
    mesh = Mesh({"pp": world}, device="cpu")
    out = {}
    for name in MODELS:
        info, params = _model(workdir, name)
        dec = PipelinedDecoder(info, params, mesh)
        t1 = dec.generate(torch.from_numpy(TOKEN0), STEPS)
        t2 = dec.generate(t1[..., -1], STEPS)
        out[name, "decoder"] = (torch.cat([t1, t2], -1).numpy(), _np_state(dec.state))
        try:
            dec.generate(torch.from_numpy(TOKEN0[:1]), STEPS)
        except EngineError as e:
            out[name, "resize"] = str(e)
        params = prepare_decode(params, info, batch_hint=B)
        pp = make_pp_params(params, mesh)
        gen = make_pp_generator(info, mesh, pp, n_groups=G, steps=STEPS)
        toks, state = gen(pp, pp_state(info, G, B, mesh=mesh), TOKEN0)
        out[name, "functional"] = (toks.numpy(), _np_state(state), sorted(pp))
        dec = PipelinedDecoder(info, params, mesh)
        for tok in FORCED:
            dec.generate(torch.from_numpy(tok), 1)
        out[name, "forced"] = _np_state(dec.state)
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from web_rwkv_gguf_tpu_torch.utils import synthetic

    d = tmp_path_factory.mktemp("pp")
    for name, (maker, kw) in MODELS.items():
        (d / f"{name}.gguf").write_bytes(bytes(getattr(synthetic, maker)(**kw)))
    return str(d)


@pytest.fixture(scope="module")
def stages(workdir):
    from web_rwkv_gguf_tpu_torch.parallel.launch import launch

    return launch(f"{__name__}:rank_main", 2, args=(workdir,), deadline=120, timeout=60)


def _whole(stages, key):
    """The stages' states ``[L / 2, G, B, ...]`` stacked on L."""
    parts = [s[key] if isinstance(s[key], dict) else s[key][1] for s in stages]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.fixture(scope="module")
def reference(workdir):
    """The port's single-rank whole-stack greedy decode, per group, 2 ×
    STEPS steps."""
    out = {}
    for name in MODELS:
        info, params = _model(workdir, name)
        params = prepare_decode(params, info, batch_hint=B)
        out[name] = [greedy_scan_reference(info, params, torch.from_numpy(TOKEN0[g]), 2 * STEPS)
                     for g in range(G)]
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_pipelined_decoder_equals_the_single_rank_generator(stages, reference, name):
    """Two ``generate`` calls of 8 steps on two stages give, per group, the
    tokens and the final state of one 16-step single-rank run, bit for
    bit; both stages return the same tokens."""
    toks = stages[0][name, "decoder"][0]
    assert np.array_equal(stages[1][name, "decoder"][0], toks)
    assert toks.shape == (G, B, 2 * STEPS)
    state = _whole(stages, (name, "decoder"))
    for g, (ref_toks, ref_state) in enumerate(reference[name]):
        assert np.array_equal(toks[g], ref_toks.numpy()), g
        for k, v in ref_state.items():
            assert np.array_equal(state[k][:, g], v.numpy()), (g, k)


@pytest.mark.parametrize("name", list(MODELS))
def test_pp_generator_functional_form(stages, reference, name):
    """``make_pp_params`` / ``pp_state`` / ``make_pp_generator``: each stage
    holds its own layers (stage 0 the embedding, the last the head) and
    the 8 steps equal the reference's first 8, per group."""
    toks, _, keys0 = stages[0][name, "functional"]
    keys1 = stages[1][name, "functional"][2]
    assert "emb" in keys0 and "head" not in keys0
    assert "head" in keys1 and "emb" not in keys1
    for g, (ref_toks, _) in enumerate(reference[name]):
        assert np.array_equal(toks[g], ref_toks.numpy()[:, :STEPS]), g


@pytest.mark.parametrize("name", list(MODELS))
def test_pipelined_decoder_refuses_a_new_shape(stages, name):
    assert "reset" in stages[0][name, "resize"]


@pytest.fixture(scope="module")
def jax_forced(workdir):
    """The JAX package's PipelinedDecoder on a ``pp`` axis of two CPU
    devices, its kernels in interpret mode, through the forced steps."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
    from web_rwkv_gguf_tpu.models import load_model as jax_load_model
    from web_rwkv_gguf_tpu.ops.pallas import config as pcfg
    from web_rwkv_gguf_tpu.parallel import PipelinedDecoder as JaxPipelinedDecoder

    out = {}
    pcfg.interpret = True
    try:
        for name in MODELS:
            info, params = jax_load_model(JaxGgufFile(open(f"{workdir}/{name}.gguf", "rb")
                                                      .read()))
            dec = JaxPipelinedDecoder(info, params,
                                      JaxMesh(np.array(jax.devices()[:2]), ("pp",)))
            for tok in FORCED:
                dec.generate(tok, 1)
            out[name] = {k: np.asarray(v) for k, v in dec.state.items()}
    finally:
        pcfg.interpret = False
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_pipelined_state_matches_jax(stages, jax_forced, name):
    """The state after two forced single steps against the JAX package's
    pipelined decoder (largest seen: 1.1e-2·max, RWKV-7's WKV state)."""
    state = _whole(stages, (name, "forced"))
    for k, want in jax_forced[name].items():
        np.testing.assert_allclose(state[k], want, rtol=0,
                                   atol=QUANT_TOL * np.abs(want).max(), err_msg=k)
