"""Parallel batched generation across lanes with continuous batching
(ref: examples/batch.rs)."""

from __future__ import annotations

import argparse
import time

from . import common

DEFAULT_PROMPTS = [
    "The Eiffel Tower is located in the city of",
    "The capital of Japan is",
    "Once upon a time, there was a dragon who",
    "In machine learning, attention is",
]


def main(argv=None):
    """Run the app; returns each lane's generated token ids."""
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    common.add_sampler_args(p)
    p.add_argument("--prompt", action="append", default=None)
    p.add_argument("--max-tokens", type=int, default=100)
    p.add_argument(
        "--fused", action="store_true",
        help="generate whole segments per call with sampling on the device "
        "(Engine.generate) instead of per-token dispatch; per-token keeps the "
        "reference's continuous-batching loop shape",
    )
    args = p.parse_args(argv)

    from ..runtime import Engine, RnnInput, RnnInputBatch, RnnOption, softmax

    prompts = args.prompt or DEFAULT_PROMPTS
    tokenizer = common.load_tokenizer(args.vocab)
    info, params = common.load_any_model(args)
    sampler = common.make_sampler(args)

    B = len(prompts)
    engine = Engine(info, params, num_batch=B, token_chunk_size=args.token_chunk_size,
                    device=args.device)

    if args.fused:
        if args.sampler not in ("greedy", "nucleus"):
            raise SystemExit("--fused supports the greedy/nucleus samplers")
        t0 = time.perf_counter()
        outs = engine.generate(
            [tokenizer.encode(pr) for pr in prompts], args.max_tokens,
            temperature=args.temp if args.sampler != "greedy" else 0.0,
            top_p=args.top_p if args.sampler == "nucleus" else 0.0,
            seed=args.seed if args.seed is not None else 0,
        )
        dt = time.perf_counter() - t0
        total = sum(len(o) for o in outs)
        for b, (pr, toks) in enumerate(zip(prompts, outs)):
            print(f"--- lane {b} ---")
            print(pr + tokenizer.decode(toks).decode("utf-8", "replace"))
        print(f"[{total} tokens across {B} lanes in {dt:.2f}s = "
              f"{total/dt:.1f} t/s]")
        return outs
    inp = RnnInput(
        [RnnInputBatch(tokenizer.encode(pr), RnnOption.LAST) for pr in prompts],
        args.token_chunk_size,
    )

    texts = list(prompts)
    outs = [[] for _ in prompts]
    remaining = [args.max_tokens] * B
    logits = [None] * B
    t0 = time.perf_counter()
    total = 0
    while any(r > 0 for r in remaining) or inp.num_token > 0:
        out = engine.infer(inp)
        for b in range(B):
            if len(out[b]):
                logits[b] = out[b][-1]
        if inp.num_token > 0:
            continue
        for b in range(B):
            if remaining[b] <= 0 or logits[b] is None:
                continue
            token = sampler.sample(softmax(logits[b][None, :])[0])
            outs[b].append(token)
            texts[b] += tokenizer.decode([token]).decode("utf-8", "replace")
            inp.batches[b].push(int(token))
            remaining[b] -= 1
            total += 1

    dt = time.perf_counter() - t0
    for b, t in enumerate(texts):
        print(f"--- lane {b} ---")
        print(t)
    print(f"[{total} tokens across {B} lanes in {dt:.2f}s = {total/dt:.1f} t/s]")
    return outs


if __name__ == "__main__":
    main()
