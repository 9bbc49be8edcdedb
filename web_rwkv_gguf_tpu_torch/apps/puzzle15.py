"""15-puzzle solver demo: a specialized RWKV-6 model searches for moves.

The port's equivalent of the reference's ``examples/puzzle15``
(main.rs:1-197). The solver model is a standard RWKV-6 checkpoint with a
tiny custom vocabulary; one structural modification is applied through
the inference hook system: before the decay activation, the attention
key is gated by the raw (pre-StableExp) decay,
``k <- exp(min(w, 0)) * k`` (``Hook::PreAttTimeDecayActivate`` + the
example's custom ``mul_exp`` WGSL kernel, examples/puzzle15/ops.rs /
mul_exp.wgsl) — here a PyTorch expression inside the hook. Decoding is
greedy and stops at the end-of-output tokens.
"""

from __future__ import annotations

import argparse

from . import common
from .othello import play

# a scrambled 4x4 board in the transcript format the solver models are
# trained on (0 = the hole)
DEFAULT_PROMPT = """<input>
<board>
5  1  2  3
4  9  6  7
8  13 10 11
12 0  14 15
</board>
</input>
"""

STOP_TOKENS = (0, 59)  # ref: examples/puzzle15/main.rs:189-192


def make_puzzle15_hooks(num_layer: int) -> dict:
    """k <- exp(min(w_raw, 0)) * k before decay activation (see module
    docstring); ``k`` is in heads form [B, T, H, hs], ``w`` flat [B, T, C]."""
    import torch

    def pre_att_decay_activate(layer, *, w, k):
        return {"k": k * torch.exp(torch.clamp_max(w, 0.0)).reshape(k.shape)}

    return {"pre_att_decay_activate": pre_att_decay_activate}


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
        hooks=make_puzzle15_hooks(info.num_layer), device=args.device,
    )
    return play(engine, tokenizer, args.prompt, args.max_tokens, info.num_vocab, STOP_TOKENS,
         args.token_chunk_size)


if __name__ == "__main__":
    main()
