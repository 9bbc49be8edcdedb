"""Text generation from a prompt (ref: examples/gen.rs)."""

from __future__ import annotations

import argparse
import sys
import time

from . import common


def main(argv=None):
    """Run the app; returns the generated token ids."""
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    common.add_sampler_args(p)
    p.add_argument("--prompt", default="The Eiffel Tower is located in the city of")
    p.add_argument("--max-tokens", type=int, default=200)
    p.add_argument("--stop", action="append", default=["\n\n"])
    p.add_argument(
        "--fused", action="store_true",
        help="generation with sampling on the device (Engine.generate: greedy or "
             "nucleus; no per-token streaming)",
    )
    args = p.parse_args(argv)

    from ..runtime import Engine, RnnInput, RnnInputBatch, RnnOption, softmax

    tokenizer = common.load_tokenizer(args.vocab)
    info, params = common.load_any_model(args)
    sampler = common.make_sampler(args)

    engine = Engine(info, params, num_batch=1, token_chunk_size=args.token_chunk_size,
                    device=args.device)
    prompt_tokens = tokenizer.encode(args.prompt)

    if args.fused:
        t0 = time.perf_counter()
        toks = engine.generate(
            [list(prompt_tokens)], args.max_tokens,
            temperature=0.0 if args.sampler == "greedy" else args.temp,
            top_p=args.top_p if args.sampler == "nucleus" else 0.0,
            seed=args.seed or 0,
        )[0]
        dt = time.perf_counter() - t0
        print(args.prompt + tokenizer.decode(toks).decode("utf-8", "replace"))
        print(
            f"[{len(prompt_tokens)} prompt + {len(toks)} generated tokens in "
            f"{dt:.2f}s = {len(toks)/dt:.0f} gen t/s]",
            file=sys.stderr,
        )
        return toks
    inp = RnnInput(
        [RnnInputBatch(list(prompt_tokens), RnnOption.LAST)], args.token_chunk_size
    )

    print(args.prompt, end="", flush=True)
    t0 = time.perf_counter()
    logits = None
    while inp.num_token > 0:
        out = engine.infer(inp)
        if len(out[0]):
            logits = out[0][-1]
    prefill_dt = time.perf_counter() - t0

    text = ""
    toks = []
    t0 = time.perf_counter()
    for _ in range(args.max_tokens):
        probs = softmax(logits[None, :])[0]
        token = sampler.sample(probs)
        toks.append(token)
        piece = tokenizer.decode([token]).decode("utf-8", errors="replace")
        text += piece
        print(piece, end="", flush=True)
        if any(s in text for s in args.stop):
            break
        inp.batches[0].push(int(token))
        out = engine.infer(inp)
        logits = out[0][-1]
    gen_dt = time.perf_counter() - t0

    print()
    print(
        f"[prefill {len(prompt_tokens)} tok in {prefill_dt*1e3:.0f} ms "
        f"({len(prompt_tokens)/max(prefill_dt,1e-9):.0f} t/s); "
        f"gen {len(toks)} tok in {gen_dt*1e3:.0f} ms "
        f"({len(toks)/max(gen_dt,1e-9):.1f} t/s)]",
        file=sys.stderr,
    )
    return toks


if __name__ == "__main__":
    main()
