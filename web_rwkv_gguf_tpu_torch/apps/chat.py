"""Interactive chat with per-session state checkpointing
(ref: examples/chat.rs — including its "+" retry via saved state and "-"
reset commands, chat.rs:350-381)."""

from __future__ import annotations

import argparse

from . import common

SYSTEM_PROMPT = (
    "The following is a coherent, verbose conversation between a girl named "
    "{bot} and her friend {user}.\n\n"
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    common.add_sampler_args(p)
    p.add_argument("--user", default="Bob")
    p.add_argument("--bot", default="Alice")
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument(
        "--fused", type=int, default=None, metavar="SEG",
        help="segment-wise generation with sampling on the device: decode SEG "
        "tokens per generator call and print them as a burst. Stop phrases are "
        "detected at token granularity but the recurrent state advances "
        "through the whole final segment (up to SEG-1 tokens past the "
        "stop). DEFAULT: 8 when the sampler supports it (greedy/nucleus); "
        "pass 0 for per-token dispatch (e.g. for logit inspection).",
    )
    args = p.parse_args(argv)
    if args.fused is None:
        args.fused = 8 if args.sampler in ("greedy", "nucleus") else 0

    from ..runtime import Engine, RnnInput, RnnInputBatch, RnnOption, softmax

    tokenizer = common.load_tokenizer(args.vocab)
    info, params = common.load_any_model(args)
    sampler = common.make_sampler(args)
    engine = Engine(info, params, num_batch=1, token_chunk_size=args.token_chunk_size,
                    device=args.device)

    inp = RnnInput([RnnInputBatch([], RnnOption.LAST)], args.token_chunk_size)

    def feed(text: str):
        inp.batches[0].append(tokenizer.encode(text))
        logits = None
        while inp.num_token > 0:
            out = engine.infer(inp)
            if len(out[0]):
                logits = out[0][-1]
        return logits

    # one generator and one torch.Generator for the whole chat
    fused = {}

    def generate_fused(logits):
        import torch

        from ..models.generate import make_generator

        if args.sampler not in ("greedy", "nucleus"):
            raise SystemExit("--fused supports the greedy/nucleus samplers")
        if not fused:
            fused["gen"] = make_generator(
                info, steps=args.fused,
                temperature=0.0 if args.sampler == "greedy" else args.temp,
                top_p=args.top_p if args.sampler == "nucleus" else 0.0,
            )
            fused["rng"] = torch.Generator(device=engine.device).manual_seed(
                args.seed if args.seed is not None else 0)
        gen, rng = fused["gen"], fused["rng"]

        def emit(token, reply):
            piece = tokenizer.decode([int(token)]).decode("utf-8", errors="replace")
            print(piece, end="", flush=True)
            return reply + piece

        probs = softmax(logits[None, :])[0]
        token = int(sampler.sample(probs))
        reply = emit(token, "")
        tok = torch.tensor([[token]], device=engine.device)
        produced = 1
        while produced < args.max_tokens and not (
            "\n\n" in reply or f"{args.user}:" in reply
        ):
            toks, _, engine.state, rng, _ = gen(engine.params, engine.state, tok, rng)
            for t in toks[0, : args.max_tokens - produced].tolist():
                reply = emit(t, reply)
                produced += 1
                if "\n\n" in reply or f"{args.user}:" in reply:
                    break
            tok = toks[:, -1:]
        print()
        return reply

    def generate(logits):
        reply = ""
        for _ in range(args.max_tokens):
            probs = softmax(logits[None, :])[0]
            token = sampler.sample(probs)
            piece = tokenizer.decode([token]).decode("utf-8", errors="replace")
            reply += piece
            print(piece, end="", flush=True)
            if "\n\n" in reply or f"{args.user}:" in reply:
                break
            inp.batches[0].push(int(token))
            out = engine.infer(inp)
            logits = out[0][-1]
        print()
        return reply

    feed(SYSTEM_PROMPT.format(user=args.user, bot=args.bot))
    initial_state = engine.back_state(0)
    retry_state = None
    retry_logits = None

    print("commands: '+' retry last reply, '-' reset conversation, ctrl-d quit")
    while True:
        try:
            line = input(f"{args.user}: ")
        except EOFError:
            return
        if line.strip() == "-":
            engine.load_state(0, initial_state)
            inp.batches[0].replace([])
            retry_state = retry_logits = None
            print("[conversation reset]")
            continue
        if line.strip() == "+":
            if retry_state is None:
                print("[nothing to retry]")
                continue
            # rewind to just after the user's last line was fed
            engine.load_state(0, retry_state)
            inp.batches[0].replace([])
            logits = retry_logits
        else:
            logits = feed(f"{args.user}: {line}\n\n{args.bot}:")
            retry_state = engine.back_state(0)
            retry_logits = logits
        print(f"{args.bot}:", end="", flush=True)
        (generate_fused if args.fused else generate)(logits)


if __name__ == "__main__":
    main()
