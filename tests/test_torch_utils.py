"""The port's ``utils`` (sampling, tokenizer, trace) and ``ops.basic.rms_norm``
against the JAX package's, on the CPU.

Exactly: each host sampler draws the same 1,000 tokens as the JAX
package's from the same probabilities and seed; the tokenizer encodes
(C++ and Python) and decodes as the JAX package's does, and fails at the
same byte offset. ``rms_norm`` within 1e-6 of JAX's on f32 and bf16
inputs. ``trace_to`` writes a Chrome trace that names a ``span``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu.ops.basic import rms_norm as jax_rms_norm
from web_rwkv_gguf_tpu.utils import sampling as jax_sampling
from web_rwkv_gguf_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from web_rwkv_gguf_tpu_torch.errors import TokenizerError
from web_rwkv_gguf_tpu_torch.ops import rms_norm
from web_rwkv_gguf_tpu_torch.utils import sampling
from web_rwkv_gguf_tpu_torch.utils.tokenizer import Tokenizer
from web_rwkv_gguf_tpu_torch.utils.trace import annotate, device_sync, span, trace_to

# ---- rms_norm -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-5, 64e-5])
def test_rms_norm_matches_jax(dtype, eps):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 5, 64)) * 2.0).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32)
    b = (0.1 * rng.normal(size=64)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    got = rms_norm(tx, torch.from_numpy(w), torch.from_numpy(b), eps)
    want = np.asarray(jax_rms_norm(jx, jnp.asarray(w), jnp.asarray(b), eps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---- samplers ---------------------------------------------------------------

V = 1000


def _probs(kind):
    rng = np.random.default_rng(11)
    if kind == "peaked":
        logits = rng.normal(size=V) * 0.5
        logits[rng.integers(V, size=3)] += 8.0
    elif kind == "flat":
        logits = rng.normal(size=V) * 0.01
    else:  # long-tailed: Zipf-like
        logits = -1.1 * np.log(np.arange(1, V + 1)) + rng.normal(size=V) * 0.1
        rng.shuffle(logits)
    p = np.exp(logits - logits.max())
    return (p / p.sum()).astype(np.float32)


DISTS = ["peaked", "flat", "long_tail"]
SAMPLER_CASES = (
    [("greedy", None, None, d) for d in DISTS]
    + [(name, mass, temp, d) for name in ("nucleus", "typical")
       for mass in (0.1, 0.5, 0.95) for temp in (0.5, 1.0) for d in DISTS]
)


def _make(mod, name, mass, temp, seed):
    if name == "greedy":
        return mod.GreedySampler()
    cls = mod.NucleusSampler if name == "nucleus" else mod.TypicalSampler
    return cls(mass, temp, seed)


@pytest.mark.parametrize("name,mass,temp,dist", SAMPLER_CASES,
                         ids=lambda v: str(v))
def test_sampler_draws_match_jax(name, mass, temp, dist):
    """1,000 draws from one distribution and seed: the same token ids."""
    probs = _probs(dist)
    port, ref = _make(sampling, name, mass, temp, 5), _make(jax_sampling, name, mass, temp, 5)
    got = [port.sample(probs) for _ in range(1000)]
    want = [ref.sample(probs) for _ in range(1000)]
    assert got == want
    assert all(isinstance(t, int) for t in got)
    if name != "greedy":
        assert len(set(got)) > 1 or mass == 0.1  # it samples, not argmax


def test_sampler_takes_an_explicit_generator():
    probs = _probs("flat")
    port = sampling.NucleusSampler(0.95, 1.0, seed=0)
    ref = jax_sampling.NucleusSampler(0.95, 1.0, seed=0)
    got = [port.sample(probs, np.random.default_rng(9)) for _ in range(20)]
    want = [ref.sample(probs, np.random.default_rng(9)) for _ in range(20)]
    assert got == want and len(set(got)) == 1


# ---- tokenizer ---------------------------------------------------------------

EXTRA = ["he", "hel", "hello", "hello ", "wor", "world", "ab", "abc", "é", "你好", "  ",
         "the ", "ing", "tion", "\n\n", "Alice:"]


def _vocab():
    vocab = {str(i): [i] for i in range(256)}
    for j, s in enumerate(EXTRA):
        vocab[str(256 + j)] = s
    vocab[str(256 + len(EXTRA))] = list("ok".encode()) + [0xFF]  # a byte-list entry
    return vocab


@pytest.fixture(scope="module")
def tokenizers():
    return Tokenizer(_vocab()), JaxTokenizer(_vocab())


def _texts():
    rng = np.random.default_rng(7)
    return {
        "empty": b"",
        "ascii": "hello world".encode(),
        "overlaps": "the theing tiontion hello  abc ab helloworld".encode(),
        "utf8": "你好, éléphant! Alice:\n\nhello".encode(),
        "random_bytes": bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
        "random_from_vocab": b"".join(
            rng.choice([s.encode() for s in EXTRA] + [b"x", b"\xff"], 500)),
    }


@pytest.mark.parametrize("case", list(_texts()))
def test_tokenizer_encodes_and_decodes_as_jax(tokenizers, case):
    tok, jtok = tokenizers
    data = _texts()[case]
    want = jtok.encode(data)
    assert tok._native is not None
    assert tok.encode(data) == want
    assert tok._native.encode(data).tolist() == want
    assert tok._encode_py(data) == want
    assert tok.decode(want) == jtok.decode(want) == data
    assert tok.decode_str(want) == jtok.decode_str(want)
    if not case.startswith("random"):
        assert tok.encode(data.decode()) == want  # str input


@pytest.mark.parametrize("data", [b"abx", b"x", b"ab\x00ab", "éax".encode()])
def test_tokenizer_error_offset_matches_jax(data):
    vocab = {"0": "a", "1": "ab", "2": "é"}
    tok, jtok = Tokenizer(vocab), JaxTokenizer(vocab)
    with pytest.raises(ValueError) as want:
        jtok.encode(data)
    with pytest.raises(TokenizerError) as got:
        tok.encode(data)
    with pytest.raises(TokenizerError) as got_py:
        tok._encode_py(data)
    assert str(got.value) == str(got_py.value) == str(want.value)


def test_tokenizer_decode_out_of_range(tokenizers):
    tok, jtok = tokenizers
    for t in (-1, tok.vocab_size):
        with pytest.raises(TokenizerError, match="out of range"):
            tok.decode([t])
    assert tok.vocab_size == jtok.vocab_size


def test_tokenizer_from_file(tmp_path):
    path = tmp_path / "vocab.json"
    path.write_text(json.dumps(_vocab()), encoding="utf-8")
    assert Tokenizer.from_file(path).encode("hello world") == \
        JaxTokenizer.from_file(path).encode("hello world")


# ---- trace ------------------------------------------------------------------


def test_trace_to_writes_a_trace_naming_a_span(tmp_path):
    with trace_to(str(tmp_path)) as prof:
        with span("port_span"):
            y = torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)
    assert any(e.key == "port_span" for e in prof.key_averages())
    assert float(y[0, 0]) == 8.0


def test_annotate_keeps_the_return_value_and_device_sync_returns():
    @annotate("doubled")
    def double(x, *, k=2):
        return x * k

    assert double(21) == 42
    assert double(2, k=3) == 6
    out = device_sync({"state": [torch.arange(5, dtype=torch.float32) + 3]})
    assert out.tolist() == [3.0]
    assert device_sync(torch.full((2, 2), 7.0)).tolist() == [7.0]
    assert device_sync({"no": "tensor"}) == {"no": "tensor"}
