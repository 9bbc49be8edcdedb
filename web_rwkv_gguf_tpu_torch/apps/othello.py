"""Othello move-search demo: a specialized RWKV-7 model plays Othello.

The port's equivalent of the reference's ``examples/othello``
(main.rs:1-197). The game model (e.g. ``rwkv7_othello_9m_L10_D256``) is a
standard RWKV-7 checkpoint trained on board transcripts with a tiny
custom vocabulary, plus two *structural* modifications applied through
the inference hook system rather than a model edit (ref:
examples/othello/main.rs:100-122):

* after the inner-LoRA adapters, the in-context-learning-rate ``a`` is
  doubled (``Hook::PostAttAdapt``: affine a*2);
* after k-control, ``a`` is gated by the activated decay,
  ``a <- act_w(w) * a`` (``Hook::PostAttControl`` + the example's custom
  ``mul_w`` WGSL kernel, examples/othello/ops.rs / mul_w.wgsl) — here a
  PyTorch expression inside the hook.

Hooks take the Engine off the whole-stack decode kernel: each step runs
layer by layer. The model emits the search trace/move tokens
autoregressively; decoding is greedy and stops at the end-of-output
tokens (main.rs:189-192).
"""

from __future__ import annotations

import argparse
import sys

from . import common

# standard opening position in the transcript format the othello models
# are trained on (dark = ●, light = ○, empty = ·), with bounded search
# width/depth directives
DEFAULT_PROMPT = """<input>
· · · · · · · ·
· · · · · · · ·
· · · · · · · ·
· · · ○ ● · · ·
· · · ● ○ · · ·
· · · · · · · ·
· · · · · · · ·
· · · · · · · ·
NEXT ●
MAX_WIDTH-2
MAX_DEPTH-2
</input>

"""

STOP_TOKENS = (0, 59)  # ref: examples/othello/main.rs:190


def make_othello_hooks(num_layer: int) -> dict:
    """The two per-layer modifications (see module docstring)."""
    from ..ops.wkv import wkv7_act_w

    def post_att_adapt(layer, *, w, a, g):
        return {"a": a * 2.0}

    def post_att_control(layer, *, k, kk, a, w):
        return {"a": wkv7_act_w(w) * a}

    return {
        "post_att_adapt": post_att_adapt,
        "post_att_control": post_att_control,
    }


def play(engine, tokenizer, prompt, max_tokens, num_vocab, stop_tokens, chunk):
    """Prefill ``prompt``, then greedy steps until a stop token or
    ``max_tokens``, streaming each piece to stdout; returns the tokens."""
    import numpy as np

    from ..runtime import RnnInput, RnnInputBatch, RnnOption

    inp = RnnInput([RnnInputBatch(list(tokenizer.encode(prompt)), RnnOption.LAST)], chunk)
    print(prompt, end="", flush=True)
    logits = None
    while inp.num_token > 0:
        out = engine.infer(inp)
        if len(out[0]):
            logits = out[0][-1]

    tokens = []
    for _ in range(max_tokens):
        token = int(np.argmax(logits[:num_vocab]))
        tokens.append(token)
        sys.stdout.write(tokenizer.decode([token]).decode("utf-8", "replace"))
        sys.stdout.flush()
        if token in stop_tokens:
            break
        inp = RnnInput([RnnInputBatch([token], RnnOption.LAST)], chunk)
        while inp.num_token > 0:
            out = engine.infer(inp)
            if len(out[0]):
                logits = out[0][-1]
    print()
    return tokens


def main(argv=None):
    """Run the app; returns the generated token ids."""
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    p.add_argument("--prompt", default=DEFAULT_PROMPT)
    p.add_argument("--max-tokens", type=int, default=512)
    args = p.parse_args(argv)

    from ..runtime import Engine

    tokenizer = common.load_tokenizer(args.vocab)
    info, params = common.load_any_model(args)
    engine = Engine(
        info, params, num_batch=1, token_chunk_size=args.token_chunk_size,
        hooks=make_othello_hooks(info.num_layer), device=args.device,
    )
    return play(engine, tokenizer, args.prompt, args.max_tokens, info.num_vocab, STOP_TOKENS,
         args.token_chunk_size)


if __name__ == "__main__":
    main()
