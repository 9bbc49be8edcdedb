"""The port's apps, each through ``main(argv)`` with ``--device cpu``, on
tiny models (2 layers, C = 32 or 64, V = 300; a Q4_K_M file at C = 256)
and a byte-level vocabulary built here, against the port's own library
path and the JAX package's apps.

- Tokens are held against the same port's library path, never against
  JAX's greedy tokens (another numerics class): gen and batch per token
  against an ``Engine.infer`` loop with the same host sampler, ``--fused``
  against ``Engine.generate``; othello and puzzle15 against a hooked
  ``Engine.infer`` loop; chat's ``+`` retry restores the state taken at
  ``back_state`` exactly.
- Against the JAX package: ``evaluate_ppl``'s nll at rtol 2e-4 on an f32
  dense file and 3e-2 on a Q4_K_M file (ROADMAP's tolerances); convert's
  output file byte for byte (so every tensor's name, dims, type, bytes and
  the metadata); inspect's printed lines; convert_vocab's JSON.
- Every output line has the JAX app's format; ``--device cuda`` with no
  card raises.
"""

import builtins
import json
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from web_rwkv_gguf_tpu.apps import convert as jax_convert
from web_rwkv_gguf_tpu.apps import convert_vocab as jax_convert_vocab
from web_rwkv_gguf_tpu.apps import inspect as jax_inspect
from web_rwkv_gguf_tpu.apps.ppl import evaluate_ppl as jax_evaluate_ppl
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.io.safetensors import write_safetensors as jax_write_safetensors
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from web_rwkv_gguf_tpu_torch.apps import (batch, chat, convert, convert_vocab, gen,
                                          inspect, othello, ppl, puzzle15, serde)
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.io import write_safetensors
from web_rwkv_gguf_tpu_torch.models import forward_chunk, init_state, load_model
from web_rwkv_gguf_tpu_torch.quant import QuantScheme
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import (Engine, RnnInput, RnnInputBatch, RnnOption,
                                             softmax)
from web_rwkv_gguf_tpu_torch.utils.sampling import GreedySampler, NucleusSampler
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf
from web_rwkv_gguf_tpu_torch.utils.tokenizer import Tokenizer

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
TEXT = "hello world, this is a test of perplexity evaluation. " * 3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    out = {"v7": d / "tiny_v7.gguf", "v6": d / "tiny_v6.gguf", "q4km": d / "q4km.gguf",
           "vocab": d / "vocab.json", "text": d / "t.txt"}
    out["v7"].write_bytes(fixtures.make_v7_gguf(n_layer=2, n_emb=32, head_size=8,
                                                n_vocab=300))
    out["v6"].write_bytes(fixtures.make_v6_gguf(n_layer=2, n_emb=32, head_size=8,
                                                n_vocab=300))
    out["q4km"].write_bytes(make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=300,
                                         n_hidden=512, quantize=GgmlDType.Q4_K,
                                         head_quantize=GgmlDType.Q6_K, seed=4))
    vocab = {str(i): [i] for i in range(256)}
    vocab.update({str(i): f"<tok{i}>" for i in range(256, 300)})
    out["vocab"].write_text(json.dumps(vocab))
    out["text"].write_text(TEXT)
    return {k: str(v) for k, v in out.items()}


def _args(files, model="v7"):
    return ["--model", files[model], "--vocab", files["vocab"], *CPU]


def _lines(capsys):
    """stdout and stderr as lines, split at newlines only (a generated byte
    may be another line break that ``splitlines`` would split at)."""
    cap = capsys.readouterr()
    return cap.out.rstrip("\n").split("\n"), cap.err.rstrip("\n").split("\n")


LOADED = re.compile(r"loaded \S+: v[4-7] L=\d+ C=\d+ V=\d+ in \d+ ms$")


def _engine(files, model="v7", num_batch=1, hooks=None):
    info, params = load_model(GgufFile(files[model]), device="cpu")
    return info, Engine(info, params, num_batch, token_chunk_size=128, hooks=hooks,
                        device="cpu")


def _decode(tok, toks):
    return tok.decode(toks).decode("utf-8", "replace")


def _pieces(tok, toks):
    """The text the per-token loops print: each token decoded alone."""
    return "".join(_decode(tok, [t]) for t in toks)


# ---- gen ----------------------------------------------------------------------

SAMPLERS = {"greedy": (["--sampler", "greedy"], lambda: GreedySampler()),
            "nucleus": (["--sampler", "nucleus", "--top-p", "0.9", "--seed", "3"],
                        lambda: NucleusSampler(0.9, 1.0, 3))}


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_gen_per_token_matches_the_engine_loop(files, capsys, sampler):
    flags, make = SAMPLERS[sampler]
    gen.main(_args(files) + flags + ["--prompt", "hi", "--max-tokens", "8",
                                     "--stop", "\x00\x00\x00"])
    out, err = _lines(capsys)
    tok = Tokenizer.from_file(files["vocab"])
    _, eng = _engine(files)
    inp = RnnInput([RnnInputBatch(tok.encode("hi"), RnnOption.LAST)], 128)
    while inp.num_token:
        o = eng.infer(inp)
        if len(o[0]):
            logits = o[0][-1]
    s, text = make(), ""
    for _ in range(8):
        t = s.sample(softmax(logits[None, :])[0])
        text += _decode(tok, [t])
        if "\n\n" in text or "\x00\x00\x00" in text:
            break
        inp.batches[0].push(int(t))
        logits = eng.infer(inp)[0][-1]
    assert LOADED.match(out[0])
    assert "\n".join(out[1:]) == "hi" + text
    assert re.fullmatch(r"\[prefill 2 tok in \d+ ms \(\d+ t/s\); gen \d+ tok in \d+ ms "
                        r"\([\d.]+ t/s\)\]", err[-1])


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_gen_fused_matches_engine_generate(files, capsys, sampler):
    flags, _ = SAMPLERS[sampler]
    gen.main(_args(files) + flags + ["--prompt", "hi", "--max-tokens", "6", "--fused"])
    out, err = _lines(capsys)
    tok = Tokenizer.from_file(files["vocab"])
    _, eng = _engine(files)
    nucleus = sampler == "nucleus"
    toks = eng.generate([tok.encode("hi")], 6, temperature=1.0 if nucleus else 0.0,
                        top_p=0.9 if nucleus else 0.0, seed=3 if nucleus else 0)[0]
    assert len(toks) == 6
    assert "\n".join(out[1:]) == "hi" + _decode(tok, toks)
    assert re.fullmatch(r"\[2 prompt \+ 6 generated tokens in [\d.]+s = \d+ gen t/s\]",
                        err[-1])


# ---- batch --------------------------------------------------------------------


def _lanes(out):
    """{lane: text} from batch's output lines."""
    lanes, cur = {}, None
    for line in out[1:-1]:
        m = re.fullmatch(r"--- lane (\d+) ---", line)
        if m:
            cur = int(m.group(1))
            lanes[cur] = []
        else:
            lanes[cur].append(line)
    return {b: "\n".join(t) for b, t in lanes.items()}


PROMPTS = ["ab", "xyz", "hello"]


@pytest.mark.parametrize("fused", [False, True])
def test_batch_matches_the_library_path(files, capsys, fused):
    argv = _args(files) + ["--sampler", "greedy", "--max-tokens", "4"]
    for p in PROMPTS:
        argv += ["--prompt", p]
    batch.main(argv + (["--fused"] if fused else []))
    out, _ = _lines(capsys)
    tok = Tokenizer.from_file(files["vocab"])
    _, eng = _engine(files, num_batch=len(PROMPTS))
    if fused:
        toks = eng.generate([tok.encode(p) for p in PROMPTS], 4)
    else:
        inp = RnnInput([RnnInputBatch(tok.encode(p), RnnOption.LAST) for p in PROMPTS], 128)
        toks = [[] for _ in PROMPTS]
        logits = [None] * len(PROMPTS)
        while any(len(t) < 4 for t in toks) or inp.num_token:
            o = eng.infer(inp)
            for b in range(len(PROMPTS)):
                if len(o[b]):
                    logits[b] = o[b][-1]
            if inp.num_token:
                continue
            for b in range(len(PROMPTS)):
                if len(toks[b]) < 4:
                    toks[b].append(int(np.argmax(logits[b])))
                    inp.batches[b].push(toks[b][-1])
    text = _decode if fused else _pieces
    assert _lanes(out) == {b: p + text(tok, t) for b, (p, t) in enumerate(zip(PROMPTS, toks))}
    assert re.fullmatch(r"\[12 tokens across 3 lanes in [\d.]+s = [\d.]+ t/s\]", out[-1])


def test_batch_fused_refuses_the_typical_sampler(files):
    with pytest.raises(SystemExit, match="greedy/nucleus"):
        batch.main(_args(files) + ["--sampler", "typical", "--fused", "--max-tokens", "2"])


# ---- chat ---------------------------------------------------------------------


def _script(monkeypatch, lines):
    it = iter(lines)

    def fake_input(prompt=""):
        print(prompt, end="")
        try:
            return next(it)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr(builtins, "input", fake_input)


@pytest.mark.parametrize("fused", ["0", "4"])
def test_chat_scripted_retry_and_reset(files, capsys, monkeypatch, fused):
    """A turn, ``+`` (the retried reply equals the first: greedy from the
    state loaded back, which equals the one ``back_state`` took bit for
    bit), ``-`` (reset), a turn, EOF."""
    loads = []
    real_load = Engine.load_state

    def load_state(self, batch, snapshot):
        real_load(self, batch, snapshot)
        loads.append(all(np.array_equal(self.back_state(batch)[k], snapshot[k])
                         for k in snapshot))

    monkeypatch.setattr(Engine, "load_state", load_state)
    _script(monkeypatch, ["hi there", "+", "-", "bye"])
    chat.main(_args(files) + ["--sampler", "greedy", "--max-tokens", "6", "--fused", fused])
    out, _ = _lines(capsys)
    assert LOADED.match(out[0])
    assert out[1] == "commands: '+' retry last reply, '-' reset conversation, ctrl-d quit"
    replies = [line for line in out if line.startswith("Bob: Alice:")]
    assert len(replies) == 3 and replies[0] == replies[1]
    assert "Bob: [conversation reset]" in out
    assert out[-1] == "Bob: "
    assert loads == [True, True]


def test_chat_default_is_fused(files, capsys, monkeypatch):
    from web_rwkv_gguf_tpu_torch.models import generate as gen_mod

    steps = []
    real = gen_mod.make_generator
    monkeypatch.setattr(gen_mod, "make_generator",
                        lambda *a, **k: steps.append(k["steps"]) or real(*a, **k))
    _script(monkeypatch, ["hi"])
    chat.main(_args(files) + ["--sampler", "greedy", "--max-tokens", "6"])
    assert any(line.startswith("Bob: Alice:") for line in _lines(capsys)[0])
    assert steps == [8]


# ---- othello, puzzle15 ----------------------------------------------------------


@pytest.mark.parametrize("app,model,prompt", [(othello, "v7", "NEXT"),
                                              (puzzle15, "v6", "board")])
def test_game_apps_match_a_hooked_engine_loop(files, capsys, app, model, prompt):
    app.main(_args(files, model) + ["--prompt", prompt, "--max-tokens", "5"])
    out, _ = _lines(capsys)
    make = getattr(app, f"make_{app.__name__.rsplit('.', 1)[1]}_hooks")
    tok = Tokenizer.from_file(files["vocab"])
    info, eng = _engine(files, model, hooks=make(2))
    inp = RnnInput([RnnInputBatch(tok.encode(prompt), RnnOption.LAST)], 128)
    toks = []
    while len(toks) < 5 and (not toks or toks[-1] not in app.STOP_TOKENS):
        while inp.num_token:
            o = eng.infer(inp)
            if len(o[0]):
                logits = o[0][-1]
        toks.append(int(np.argmax(logits[:info.num_vocab])))
        inp = RnnInput([RnnInputBatch([toks[-1]], RnnOption.LAST)], 128)
    assert LOADED.match(out[0])
    assert "\n".join(out[1:]) == prompt + _pieces(tok, toks)


# the example hooks as chip_smoke.py defined them before it took them from
# the apps (the JAX package's apps/othello.py:50-64, apps/puzzle15.py:36-45)
def _othello_copy(wkv7_act_w):
    def post_att_adapt(layer, *, w, a, g):
        return {"a": a * 2.0}

    def post_att_control(layer, *, k, kk, a, w):
        return {"a": wkv7_act_w(w) * a}

    return {"post_att_adapt": post_att_adapt, "post_att_control": post_att_control}


def _puzzle15_copy():
    def pre_att_decay_activate(layer, *, w, k):
        return {"k": k * torch.exp(torch.clamp_max(w, 0.0)).reshape(k.shape)}

    return {"pre_att_decay_activate": pre_att_decay_activate}


@pytest.mark.parametrize("name,model", [("othello", "v7"), ("puzzle15", "v6")])
def test_game_hooks_match_the_chip_smoke_copies(files, name, model):
    """The apps' hooks give chip_smoke.py's former copies' chunk outputs
    bit for bit, and chip_smoke.HOOK_EXAMPLES is the apps' hooks."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from web_rwkv_gguf_tpu_torch.ops import wkv as W

    info, params = load_model(GgufFile(files[model]), device="cpu")
    toks = torch.tensor([[1, 200, 3, 44], [7, 8, 9, 0]])
    lens = torch.tensor([4, 3])
    apps_hooks = (othello.make_othello_hooks(2) if name == "othello"
                  else puzzle15.make_puzzle15_hooks(2))
    copy = _othello_copy(W.wkv7_act_w) if name == "othello" else _puzzle15_copy()
    runs = [forward_chunk(info, params, init_state(info, 2, device="cpu"), toks, lens,
                          hooks=h)
            for h in (apps_hooks, copy, chip_smoke.HOOK_EXAMPLES[name](2), None)]
    (x0, s0), *same, (xu, _) = runs
    for x, s in same:
        assert torch.equal(x, x0) and all(torch.equal(s[k], s0[k]) for k in s0)
    assert float((x0 - xu).abs().max()) > 1e-4


# ---- serde, inspect -------------------------------------------------------------


def test_serde_then_gen_from_the_snapshot(files, tmp_path, capsys):
    snap = str(tmp_path / "model.rwkvz")
    serde.main(_args(files) + ["--quant", "int8", "--output", snap])
    out, _ = _lines(capsys)
    assert LOADED.match(out[0])
    assert re.fullmatch(rf"wrote {re.escape(snap)}: [\d.]+ MB in [\d.]+s", out[1])
    gen.main(["--model", snap, "--vocab", files["vocab"], *CPU, "--prompt", "ok",
              "--max-tokens", "3", "--sampler", "greedy", "--fused"])
    out, _ = _lines(capsys)
    assert out[0].startswith("loaded model.rwkvz: v7 L=2 C=32 V=300")
    tok = Tokenizer.from_file(files["vocab"])
    info, params = load_model(GgufFile(files["v7"]), quant=QuantScheme.INT8, device="cpu")
    want = Engine(info, params, 1, device="cpu").generate([tok.encode("ok")], 3)[0]
    assert out[1] == "ok" + _decode(tok, want)


@pytest.mark.parametrize("model", ["v7", "q4km"])
def test_inspect_prints_jax_lines(files, capsys, model):
    argv = [files[model], "--tensors", "--stats", "--detect"]
    jax_inspect.main(argv)
    want, _ = _lines(capsys)
    inspect.main(argv)
    got, _ = _lines(capsys)
    assert got == want
    assert "tensors:" in got and "statistics:" in got and got[-1].startswith("detected:")


# ---- ppl ----------------------------------------------------------------------


@pytest.mark.parametrize("model,dtype,rtol", [("v7", "float32", 2e-4), ("q4km", None, 3e-2)])
def test_evaluate_ppl_matches_jax(files, model, dtype, rtol):
    kw = dict(dtype=getattr(torch, dtype)) if dtype else {}
    jkw = dict(dtype=getattr(jnp, dtype)) if dtype else {}
    info, params = load_model(GgufFile(files[model]), device="cpu", **kw)
    jinfo, jparams = jax_load_model(JaxGgufFile(files[model]), **jkw)
    tok, jtok = Tokenizer.from_file(files["vocab"]), JaxTokenizer.from_file(files["vocab"])
    # three chunks of 32 carry the state; JAX compiles one chunk shape
    got = ppl.evaluate_ppl(info, params, tok, TEXT, chunk=32, max_tokens=95)
    want = jax_evaluate_ppl(jinfo, jparams, jtok, TEXT, chunk=32, max_tokens=95)
    assert got[2] == want[2] == 95
    np.testing.assert_allclose(got[1], want[1], rtol=rtol)
    np.testing.assert_allclose(got[0], np.exp(got[1]), rtol=1e-12)


def test_ppl_chunking_invariant(files):
    """The state carries across chunks: the nll does not depend on the
    chunk size."""
    info, params = load_model(GgufFile(files["v7"]), dtype=torch.float32, device="cpu")
    tok = Tokenizer.from_file(files["vocab"])
    a = ppl.evaluate_ppl(info, params, tok, TEXT, chunk=8)
    b = ppl.evaluate_ppl(info, params, tok, TEXT, chunk=64)
    assert a[2] == b[2] == len(TEXT) - 1
    np.testing.assert_allclose(a[1], b[1], rtol=1e-5)


def test_ppl_app(files, capsys):
    ppl.main(_args(files) + ["--text", files["text"], "--max-tokens", "64", "--chunk", "16"])
    out, _ = _lines(capsys)
    assert LOADED.match(out[0])
    m = re.fullmatch(r"tokens=(\d+) nll=([\d.]+) ppl=([\d.]+)", out[1])
    assert m and int(m.group(1)) == 64


def test_ppl_compare_f16(files, capsys):
    """Both loads of the Q4_K_M file, each line in the JAX app's format;
    each mode's printed nll is evaluate_ppl's on that load (the loads'
    numbers against the JAX package: test_evaluate_ppl_matches_jax)."""
    res = ppl.main(_args(files, "q4km") + ["--text", files["text"], "--max-tokens", "48",
                                           "--chunk", "16", "--compare-f16"])
    out, _ = _lines(capsys)
    assert len(out) == 4
    tok = Tokenizer.from_file(files["vocab"])
    data = open(files["q4km"], "rb").read()
    for line, (mode, direct) in zip(out, (("direct-quant", True), ("f16-dequant", False))):
        m = re.fullmatch(rf"{mode} *: tokens=48 nll=([\d.]+) ppl=[\d.]+", line)
        assert m, line
        info, params = load_model(GgufFile(data, allow_quantized_direct=direct), device="cpu")
        want = ppl.evaluate_ppl(info, params, tok, TEXT, chunk=16, max_tokens=48)
        assert res[mode][:3] == want and m.group(1) == f"{want[1]:.4f}"
        assert res[mode][3] > 0  # the load's seconds
    assert re.fullmatch(r"delta ppl \(direct - f16\): [+-][\d.]+   delta nll: [+-][\d.]+"
                        r"   first-chunk max logit rel-diff: [\d.]+e[+-]\d+", out[2])
    assert out[3] in ("PASS (<=0.005 nll delta)", "FAIL (>0.005 nll delta)")


# ---- convert, convert_vocab -----------------------------------------------------


def _t(rng, *s, scale=0.3):
    return torch.tensor(rng.normal(size=s).astype(np.float32) * scale)


def _v7_sd(C=256, L=2, HS=64, V=64, HID=512, D=8, seed=0):
    """A BlinkDL-style RWKV-7 state dict (tests/test_apps.py's layout)."""
    rng = np.random.default_rng(seed)
    sd = {"emb.weight": _t(rng, V, C), "blocks.0.ln0.weight": 1 + _t(rng, C, scale=0.05),
          "blocks.0.ln0.bias": _t(rng, C, scale=0.05),
          "ln_out.weight": 1 + _t(rng, C, scale=0.05), "ln_out.bias": _t(rng, C, scale=0.05),
          "head.weight": _t(rng, V, C)}
    for i in range(L):
        p = f"blocks.{i}."
        sd.update({p + "ln1.weight": 1 + _t(rng, C, scale=0.05),
                   p + "ln1.bias": _t(rng, C, scale=0.05),
                   p + "ln2.weight": 1 + _t(rng, C, scale=0.05),
                   p + "ln2.bias": _t(rng, C, scale=0.05),
                   **{p + f"att.x_{s}": _t(rng, 1, 1, C) for s in "rwkvag"},
                   p + "att.w0": _t(rng, 1, 1, C), p + "att.w1": _t(rng, C, D),
                   p + "att.w2": _t(rng, D, C), p + "att.a0": _t(rng, 1, 1, C),
                   p + "att.a1": _t(rng, C, D), p + "att.a2": _t(rng, D, C),
                   p + "att.g1": _t(rng, C, D), p + "att.g2": _t(rng, D, C),
                   p + "att.k_k": _t(rng, 1, 1, C), p + "att.k_a": _t(rng, 1, 1, C),
                   p + "att.r_k": _t(rng, C // HS, HS),
                   **{p + f"att.{m}.weight": _t(rng, C, C)
                      for m in ("key", "value", "receptance", "output")},
                   p + "att.ln_x.weight": 1 + _t(rng, C, scale=0.05),
                   p + "att.ln_x.bias": _t(rng, C, scale=0.05),
                   p + "ffn.x_k": _t(rng, 1, 1, C), p + "ffn.key.weight": _t(rng, HID, C),
                   p + "ffn.value.weight": _t(rng, C, HID)})
        if i > 0:
            sd.update({p + "att.v0": _t(rng, 1, 1, C), p + "att.v1": _t(rng, C, D),
                       p + "att.v2": _t(rng, D, C)})
    return sd


def _v6_sd(C=256, L=2, HS=64, V=48, HID=512, RTM=4, RTD=8, seed=3):
    """A BlinkDL-style RWKV-6 state dict (ddlerp and decay LoRA in the
    checkpoint's [in, out] layout)."""
    rng = np.random.default_rng(seed)
    sd = {"emb.weight": _t(rng, V, C), "blocks.0.ln0.weight": 1 + _t(rng, C, scale=0.05),
          "blocks.0.ln0.bias": _t(rng, C, scale=0.05),
          "ln_out.weight": 1 + _t(rng, C, scale=0.05), "ln_out.bias": _t(rng, C, scale=0.05),
          "head.weight": _t(rng, V, C)}
    for i in range(L):
        p = f"blocks.{i}."
        sd.update({p + "ln1.weight": 1 + _t(rng, C, scale=0.05),
                   p + "ln1.bias": _t(rng, C, scale=0.05),
                   p + "ln2.weight": 1 + _t(rng, C, scale=0.05),
                   p + "ln2.bias": _t(rng, C, scale=0.05),
                   p + "att.time_maa_x": _t(rng, 1, 1, C),
                   **{p + f"att.time_maa_{s}": _t(rng, 1, 1, C) for s in "wkvrg"},
                   p + "att.time_maa_w1": _t(rng, C, 5 * RTM),
                   p + "att.time_maa_w2": _t(rng, 5, RTM, C),
                   p + "att.time_decay": _t(rng, 1, 1, C),
                   p + "att.time_decay_w1": _t(rng, C, RTD),
                   p + "att.time_decay_w2": _t(rng, RTD, C),
                   p + "att.time_faaaa": _t(rng, C // HS, HS),
                   **{p + f"att.{m}.weight": _t(rng, C, C)
                      for m in ("key", "value", "receptance", "gate", "output")},
                   p + "att.ln_x.weight": 1 + _t(rng, C, scale=0.05),
                   p + "att.ln_x.bias": _t(rng, C, scale=0.05),
                   p + "ffn.time_maa_k": _t(rng, 1, 1, C),
                   p + "ffn.time_maa_r": _t(rng, 1, 1, C),
                   p + "ffn.key.weight": _t(rng, HID, C),
                   p + "ffn.value.weight": _t(rng, C, HID),
                   p + "ffn.receptance.weight": _t(rng, C, C)})
    return sd


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for version, sd in (("v7", _v7_sd()), ("v6", _v6_sd())):
        out[(version, "pth")] = d / f"{version}.pth"
        torch.save(sd, out[(version, "pth")])
        out[(version, "st")] = d / f"{version}.st"
        write_safetensors(out[(version, "st")], {k: v.numpy() for k, v in sd.items()})
    return {k: str(v) for k, v in out.items()}


@pytest.mark.parametrize("version", ["v7", "v6"])
@pytest.mark.parametrize("container", ["pth", "st"])
@pytest.mark.parametrize("outtype", ["f16", "q8_0", "q4_k"])
def test_convert_matches_jax(checkpoints, tmp_path, capsys, version, container, outtype):
    """The output file equals the JAX package's converter's, byte for byte,
    and loads and runs in the port."""
    src = checkpoints[(version, container)]
    out = tmp_path / "out.gguf"
    convert.main([src, "--output", str(out), "--outtype", outtype])
    lines, _ = _lines(capsys)
    n = len(convert.load_checkpoint(src))
    assert lines[0] == f"{n} tensors, detected {version}"
    assert re.fullmatch(rf"wrote {re.escape(str(out))}: [\d.]+ MB", lines[-1])
    want = jax_convert.convert(jax_convert.load_checkpoint(src), outtype).tobytes()
    got = out.read_bytes()
    assert got == want
    reader, jreader = GgufFile(got), JaxGgufFile(want)
    assert reader.metadata == jreader.metadata
    kinds = {info.dtype.name for info in reader.tensors.values()}
    assert {"f16": "F16", "q8_0": "Q8_0", "q4_k": "Q4_K"}[outtype] in kinds
    info, params = load_model(reader, device="cpu")
    assert info.version.value == version
    x, _ = forward_chunk(info, params, init_state(info, 1, device="cpu"),
                         torch.tensor([[1, 2, 3]]), torch.tensor([3]))
    assert bool(torch.isfinite(x).all())


def test_convert_to_safetensors_matches_jax(checkpoints, tmp_path, capsys):
    src = checkpoints[("v7", "pth")]
    out = tmp_path / "out.st"
    convert.main([src, "--output", str(out), "--outtype", "f16"])
    sd = jax_convert.load_checkpoint(src)
    want = tmp_path / "want.st"
    jax_write_safetensors(want, {k: np.asarray(v).squeeze().astype(np.float16)
                                 if np.asarray(v).ndim > 2 else np.asarray(v, np.float16)
                                 for k, v in sd.items()})
    assert out.read_bytes() == want.read_bytes()
    assert capsys.readouterr().out.splitlines()[0] == f"{len(sd)} tensors, detected v7"


def test_convert_vocab_matches_jax(tmp_path, capsys):
    txt = tmp_path / "vocab.txt"
    txt.write_text("\n".join([
        "1 '\\x00' 1", "2 'a' 1", "3 b'\\xe4\\xbd' 2", "4 'hello world' 11", "",
        "5 '你好' 6", "6 b'\\n\\n' 2", "7 ' ' 1",
    ]) + "\n", encoding="utf-8")
    got, want = tmp_path / "got.json", tmp_path / "want.json"
    convert_vocab.main([str(txt), "--output", str(got)])
    jax_convert_vocab.main([str(txt), "--output", str(want)])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"wrote {got}: 7 tokens", f"wrote {want}: 7 tokens"]
    assert got.read_bytes() == want.read_bytes()
    assert Tokenizer.from_file(got).encode("hello world\n\n") == [4, 6]


# ---- the device ---------------------------------------------------------------


@pytest.mark.parametrize("app", [gen, batch, chat, ppl, serde, othello, puzzle15],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_device_cuda_without_a_card_raises(files, tmp_path, app):
    """The default ``--device cuda`` raises where there is no card; no
    app carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    extra = {ppl: ["--text", files["text"]], serde: ["--output", str(tmp_path / "s.rwkvz")]}
    argv = ["--model", files["v7"], "--vocab", files["vocab"], *extra.get(app, [])]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        app.main(argv)


# ---- bench_kernels and bench_format -------------------------------------------

BENCH_ROW = re.compile(r"^(dense_bf16|q4_k|q8_0|int8) +(\d+) +\d+\.\d +\d+\.\d +\d+$")


def test_bench_kernels_prints_the_jax_table(capsys):
    """Each kind at each N: one row of the JAX app's columns (its header
    line, its kernels and N in its order), timed on the CPU's plain
    versions; ``--device cuda`` raises where there is no card."""
    from web_rwkv_gguf_tpu.apps import bench_kernels as jax_bench_kernels
    from web_rwkv_gguf_tpu_torch.apps import bench_kernels

    argv = ["--m", "256", "--k", "256", "--n", "1", "--n", "64", "--runs", "1",
            "--warmup", "0"]
    bench_kernels.main(argv + CPU)
    got = capsys.readouterr().out.rstrip("\n").split("\n")
    jax_bench_kernels.main(argv)
    want = capsys.readouterr().out.rstrip("\n").split("\n")
    assert got[0] == "matmul [256x256] on cpu"
    assert got[1] == want[1]
    rows = [BENCH_ROW.match(line) for line in got[2:]]
    assert all(rows) and len(rows) == 8
    assert [m.groups() for m in rows] == [BENCH_ROW.match(line).groups()
                                          for line in want[2:]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            bench_kernels.main(argv)


def test_bench_format_prints_the_jax_table(files, capsys):
    """One two-layer file: the loaded line, then the JAX app's header, rule
    and a row with the file's name and its six columns; the prefill and
    generation rates it returns are positive. ``--device cuda`` raises
    where there is no card."""
    from web_rwkv_gguf_tpu.apps import bench_format as jax_bench_format
    from web_rwkv_gguf_tpu_torch.apps import bench_format

    argv = [files["v7"], "--prefill-tokens", "16", "--gen-tokens", "2", "--runs", "1",
            "--warmup", "0"]
    rows = bench_format.main(argv + CPU)
    got = capsys.readouterr().out.rstrip("\n").split("\n")
    jax_bench_format.main(argv + ["--no-pallas"])
    want = capsys.readouterr().out.rstrip("\n").split("\n")
    assert LOADED.match(got[0])
    assert got[1:3] == want[-3:-1]
    assert re.match(r"^tiny_v7\.gguf +\d+\.\d +\d+ +-?\d+\.\d +\d+ +\d+\.\d$", got[3])
    assert len(got) == 4 and len(rows) == 1
    assert rows[0]["prefill_tps"] > 0 and rows[0]["gen_tps"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            bench_format.main(argv)
