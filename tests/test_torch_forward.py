"""The port's forward, head and generator against the JAX package's, on
the CPU, from the same GGUF bytes; plus the port's own invariants
(chunked vs whole prefill, padding, stop ids, sampling).

Tolerances:

- f32 dense: rtol = atol = 2e-4 on logits and every state array, as
  tests/test_oracle.py:228 holds the JAX forward to its scalar oracle.
- Q4_K_M: the JAX CPU path rounds the dequantized Q4_K weights to bf16
  (web_rwkv_gguf_tpu/models/matrix.py:545-552), the port keeps them in
  f32 as its kernels do. Logits agree to atol = 3e-2·max|logit| (largest
  seen: 1.2e-2) and each state array to atol = 5e-2·max|state| (largest
  seen: 1.9e-2, the WKV state; random weights of scale 0.5 drive it to
  ~10^2). Greedy tokens are compared only within one numerics class.
- Port against itself (chunking, padding, batch lanes): the same f32
  math in another order or blocking, atol = 1e-5·max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import forward_chunk as jax_forward_chunk
from web_rwkv_gguf_tpu.models import init_state as jax_init_state
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models import logits_head as jax_logits_head
from web_rwkv_gguf_tpu.models.generate import make_generator as jax_make_generator
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    forward_chunk, init_state, load_model, logits_head, make_generator, make_sampler,
)
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType

F32_TOL = 2e-4
Q4KM_LOGITS_TOL = 3e-2
Q4KM_STATE_TOL = 5e-2
SELF_TOL = 1e-5


@pytest.fixture(scope="module")
def f32_models():
    raw = _f32_bytes()
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), dtype=jnp.float32)
    info, params = load_model(GgufFile(raw), dtype=torch.float32, device="cpu")
    return (jinfo, jparams), (info, params)


def _f32_bytes(**kw):
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    return make_v7_gguf(n_layer=2, n_emb=32, head_size=8, n_vocab=48, seed=11, **kw)


@pytest.fixture(scope="module")
def q4km_models():
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512,
                       n_hidden=1024, quantize=GgmlDType.Q4_K,
                       head_quantize=GgmlDType.Q6_K, seed=12)
    return jax_load_model(JaxGgufFile(raw)), load_model(GgufFile(raw), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _close_to_max(got, want, rel):
    """|got - want| <= rel·max|want| everywhere."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _run_both(jax_model, port_model, chunks, batch):
    """Feed the same (tokens, lengths) chunks to both; yield per chunk
    (jax x, port x, jax state, port state)."""
    (jinfo, jparams), (info, params) = jax_model, port_model
    jst, st = jax_init_state(jinfo, batch), init_state(info, batch, device="cpu")
    for toks, lens in chunks:
        jx, jst = jax_forward_chunk(jinfo, jparams, jst, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(lens, jnp.int32))
        x, st = forward_chunk(info, params, st, _t(np.asarray(toks)), _t(np.asarray(lens)))
        yield jx, x, jst, st


F32_CHUNKS = [
    (np.array([[3, 7, 1, 9, 4], [5, 2, 8, 0, 0]]), np.array([5, 3])),  # padded prefill
    (np.array([[6], [11]]), np.array([1, 1])),
    (np.array([[12], [40]]), np.array([1, 0])),  # lane 1 frozen
    (np.array([[47], [1]]), np.array([1, 1])),
]


def test_forward_f32_matches_jax(f32_models):
    """Padded T=5 prefill, then T=1 steps: x at every valid position,
    logits and every state array. x at a padded position is unspecified:
    the JAX package's own WKV routes differ there (its XLA reference reads
    y from the discarded update, its Pallas scan, which the port's scan
    follows, from the kept state)."""
    jax_model, port_model = f32_models
    for (toks, lens), (jx, x, jst, st) in zip(
            F32_CHUNKS, _run_both(jax_model, port_model, F32_CHUNKS, 2)):
        valid = np.arange(toks.shape[1])[None, :] < lens[:, None]
        _close(x.numpy()[valid], np.asarray(jx)[valid], F32_TOL)
        last = np.maximum(lens - 1, 0)  # each lane's last valid position
        _close(logits_head(port_model[1], x[np.arange(2), last]),
               jax_logits_head(jax_model[1], jx[np.arange(2), last]), F32_TOL)
        for key in jst:
            _close(st[key], jst[key], F32_TOL)


def test_forward_q4km_matches_jax(q4km_models):
    """Q4_K_M (Q4_K layers, Q6_K head) decode steps at T=1 through the
    gemv and attention-core wrappers, at the stated tolerance."""
    jax_model, port_model = q4km_models
    chunks = [(np.array([[t]]), np.array([1])) for t in (5, 300, 17, 511)]
    for jx, x, jst, st in _run_both(jax_model, port_model, chunks, 1):
        _close_to_max(logits_head(port_model[1], x[:, 0]),
                      jax_logits_head(jax_model[1], jx[:, 0]), Q4KM_LOGITS_TOL)
        for key in jst:
            _close_to_max(st[key], jst[key], Q4KM_STATE_TOL)


def test_generator_f32_matches_jax(f32_models):
    """Greedy 4-step generation: same tokens (one numerics class), last
    logits and state."""
    (jinfo, jparams), (info, params) = f32_models
    prompt = np.array([[3, 7, 1], [9, 4, 2]])
    lens = np.array([3, 3])
    jst, st = jax_init_state(jinfo, 2), init_state(info, 2, device="cpu")
    jx, jst = jax_forward_chunk(jinfo, jparams, jst, jnp.asarray(prompt, jnp.int32),
                                jnp.asarray(lens, jnp.int32))
    x, st = forward_chunk(info, params, st, _t(prompt), _t(lens))
    first = np.asarray(jnp.argmax(jax_logits_head(jparams, jx[:, -1]), -1))
    assert np.array_equal(first, logits_head(params, x[:, -1]).argmax(-1).numpy())
    jtoks, jlogits, jst, _, jdone = jax_make_generator(jinfo, steps=4)(
        jparams, jst, jnp.asarray(first[:, None], jnp.int32), jax.random.PRNGKey(0))
    toks, logits, st, _, done = make_generator(info, steps=4)(params, st, _t(first[:, None]))
    assert np.array_equal(toks.numpy(), np.asarray(jtoks))
    assert np.array_equal(done.numpy(), np.asarray(jdone))
    _close(logits, jlogits, F32_TOL)
    for key in jst:
        _close(st[key], jst[key], F32_TOL)


def test_generator_q4km_logits_match_jax(q4km_models):
    """Q4_K_M generation: the port's last logits and state against the JAX
    generator fed the port's tokens (tokens may differ across the two
    numerics classes, so the JAX side is driven with the port's)."""
    (jinfo, jparams), (info, params) = q4km_models
    toks, logits, st, _, _ = make_generator(info, steps=3)(
        params, init_state(info, 1, device="cpu"), torch.tensor([[7]]))
    feed = np.concatenate([[7], toks[0, :-1].numpy()])
    jst = jax_init_state(jinfo, 1)
    for t in feed:
        jx, jst = jax_forward_chunk(jinfo, jparams, jst, jnp.asarray([[t]], jnp.int32),
                                    jnp.asarray([1], jnp.int32))
    _close_to_max(logits, jax_logits_head(jparams, jx[:, 0]), Q4KM_LOGITS_TOL)
    for key in jst:
        _close_to_max(st[key], jst[key], Q4KM_STATE_TOL)


@pytest.mark.parametrize("split", [1, 2, 4])
def test_chunked_equals_whole(f32_models, split):
    """Prefill in chunks == prefill in one chunk (x at the last token, state)."""
    info, params = f32_models[1]
    toks = torch.tensor([[3, 7, 1, 9, 4, 2, 8, 6]])
    x_all, st_all = forward_chunk(info, params, init_state(info, 1, device="cpu"),
                                  toks, torch.tensor([8]))
    st = init_state(info, 1, device="cpu")
    for i in range(0, 8, split):
        x, st = forward_chunk(info, params, st, toks[:, i:i + split],
                              torch.tensor([split]))
    _close_to_max(x[:, -1], x_all[:, -1], SELF_TOL)
    for key in st:
        _close_to_max(st[key], st_all[key], SELF_TOL)


def test_padding_invariance(f32_models):
    """A padded lane's valid tokens and state equal its unpadded run; a
    zero-length lane keeps its state exactly."""
    info, params = f32_models[1]
    toks = torch.tensor([[3, 7, 1, 9], [5, 2, 0, 0], [4, 4, 4, 4]])
    lens = torch.tensor([4, 2, 0])
    g = torch.Generator().manual_seed(0)
    st0 = {k: 0.1 * torch.rand(v.shape, generator=g)
           for k, v in init_state(info, 3, device="cpu").items()}
    x, st = forward_chunk(info, params, st0, toks, lens)
    one = {k: v[:, 1:2] for k, v in st0.items()}
    x1, st1 = forward_chunk(info, params, one, toks[1:2, :2], lens[1:2])
    _close_to_max(x[1:2, :2], x1, SELF_TOL)
    for key in st:
        _close_to_max(st[key][:, 1:2], st1[key], SELF_TOL)
        assert torch.equal(st[key][:, 2], st0[key][:, 2])


def test_generator_stop_ids(f32_models):
    """A lane that emits a stop id freezes: it re-emits the id and keeps
    its state; the other lane runs on."""
    info, params = f32_models[1]
    st0 = init_state(info, 2, device="cpu")
    toks, _, _, _, _ = make_generator(info, steps=3)(params, st0, torch.tensor([[3], [9]]))
    stop = int(toks[0, 0])
    toks2, _, st, _, done = make_generator(info, steps=3, stop_ids=(stop,))(
        params, st0, torch.tensor([[3], [9]]))
    assert toks2[0].tolist() == [stop] * 3
    assert bool(done[0])
    # lane 0 advanced exactly one token (the one that emitted the stop id)
    _, st1 = forward_chunk(info, params, {k: v[:, :1] for k, v in st0.items()},
                           torch.tensor([[3]]), torch.tensor([1]))
    for key in st:
        _close_to_max(st[key][:, :1], st1[key], SELF_TOL)


def test_sampler_modes():
    """Greedy; top-k 1 and a tiny top-p reduce to greedy; temperature
    sampling follows its generator's seed and stays inside top-k."""
    logits = torch.tensor([[0.1, 2.0, -1.0, 1.5, 0.3], [3.0, 0.0, 0.2, -2.0, 2.9]])
    greedy = make_sampler()(logits, None)
    assert greedy.tolist() == [1, 0]
    assert make_sampler(temperature=1.0, top_k=1)(logits, torch.Generator().manual_seed(0)).tolist() == [1, 0]
    assert make_sampler(temperature=1.0, top_p=1e-6)(logits, torch.Generator().manual_seed(0)).tolist() == [1, 0]
    s = make_sampler(temperature=0.7, top_k=2)

    def draws():
        g = torch.Generator().manual_seed(5)
        return [s(logits, g).tolist() for _ in range(20)]

    a = draws()
    assert a == draws()
    assert all(t[0] in (1, 3) and t[1] in (0, 4) for t in a)
