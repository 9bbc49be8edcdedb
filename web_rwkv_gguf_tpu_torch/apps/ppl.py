"""Perplexity evaluation (new vs the reference — needed for quantization
QA; the reference only had "coherent output" acceptance, plan.md:300-308).

Computes token-level negative log likelihood over a text file, one logit
row per position, chunk by chunk with the state carried across chunks."""

from __future__ import annotations

import argparse
import math
import time

import numpy as np

from . import common


def evaluate_ppl(info, params, tokenizer, text, *, chunk=256, max_tokens=None):
    """``(ppl, nll per token, tokens scored)`` of ``text`` on the params'
    device. Each chunk's NLL is summed there (``logsumexp`` over its
    ``[T, V]`` logits), so one scalar a chunk comes back to the host."""
    import torch

    from ..models import forward_chunk, init_state, logits_head

    tokens = tokenizer.encode(text)
    if max_tokens:
        tokens = tokens[: max_tokens + 1]
    if len(tokens) < 2:
        raise ValueError("need at least 2 tokens")

    dev = params["emb"].device
    state = init_state(info, 1, device=dev)
    total_nll, total_n = 0.0, 0
    pos = 0
    while pos < len(tokens):
        seg = tokens[pos : pos + chunk]
        x, state = forward_chunk(
            info, params, state, torch.tensor([seg], device=dev),
            torch.tensor([len(seg)], device=dev),
        )
        # row i (global position pos+i) predicts tokens[pos+i+1]
        targets = tokens[pos + 1 : pos + len(seg) + 1]
        if targets:
            lg = logits_head(params, x[0, : len(targets)]).float()
            logp = lg - torch.logsumexp(lg, dim=-1, keepdim=True)
            tgt = torch.tensor(targets, device=dev)
            total_nll += float(-logp.gather(-1, tgt[:, None]).sum())
            total_n += len(targets)
        pos += len(seg)
    nll = total_nll / total_n
    return math.exp(nll), nll, total_n


def compare_f16(args, tokenizer, text):
    """Quantization-QA mode: evaluate the SAME .gguf through the direct
    K-quant path and through dense f16 dequant (the reference's load
    path, GgufFile(allow_quantized_direct=False)), report both ppls,
    their delta, and the max relative logit difference on the first
    chunk. Acceptance: |delta nll| <= 0.005 nats — the scale-invariant
    form of SURVEY §7's "<=0.1 ppl delta at ppl ~20". Returns each
    mode's ``(ppl, nll, tokens, load seconds)``."""
    import torch

    from ..gguf import GgufFile
    from ..models import forward_chunk, init_state, load_model, logits_head

    dev = common.device(args)
    data = open(args.model, "rb").read()
    results = {}
    logit_rows = {}
    toks = tokenizer.encode(text)[: min(256, args.max_tokens)]
    for mode, direct in (("direct-quant", True), ("f16-dequant", False)):
        t0 = time.perf_counter()
        info, params = load_model(GgufFile(data, allow_quantized_direct=direct), device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        ppl, nll, n = evaluate_ppl(
            info, params, tokenizer, text, chunk=args.chunk,
            max_tokens=args.max_tokens,
        )
        results[mode] = (ppl, nll, n, t_load)
        x, _ = forward_chunk(
            info, params, init_state(info, 1, device=dev),
            torch.tensor([toks], device=dev), torch.tensor([len(toks)], device=dev),
        )
        logit_rows[mode] = logits_head(params, x[0]).float().cpu().numpy()
        del params
        print(f"{mode:13s}: tokens={n} nll={nll:.4f} ppl={ppl:.3f}")
    d_ppl = results["direct-quant"][0] - results["f16-dequant"][0]
    d_nll = results["direct-quant"][1] - results["f16-dequant"][1]
    a, b = logit_rows["direct-quant"], logit_rows["f16-dequant"]
    rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-9)
    print(f"delta ppl (direct - f16): {d_ppl:+.4f}   delta nll: {d_nll:+.5f}"
          f"   first-chunk max logit rel-diff: {rel:.2e}")
    # scale-invariant acceptance: |delta nll| <= 0.005 nats == |delta
    # ppl| <= 0.1 at ppl ~20 (the SURVEY §7 bound for a real model)
    print("PASS (<=0.005 nll delta)" if abs(d_nll) <= 0.005 else
          "FAIL (>0.005 nll delta)")
    return results


def main(argv=None):
    """Run the app; returns ``(ppl, nll, tokens)``, or with ``--compare-f16``
    :func:`compare_f16`'s results."""
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    p.add_argument("--text", required=True, help="text file to evaluate")
    p.add_argument("--max-tokens", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument(
        "--compare-f16", action="store_true",
        help="also evaluate through dense f16 dequant and report the "
        "ppl delta + logit diff (quantization acceptance; .gguf only)",
    )
    args = p.parse_args(argv)

    tokenizer = common.load_tokenizer(args.vocab)
    text = open(args.text, encoding="utf-8").read()
    if args.compare_f16:
        if not args.model.endswith(".gguf"):
            raise SystemExit("--compare-f16 needs a .gguf model")
        return compare_f16(args, tokenizer, text)
    info, params = common.load_any_model(args)
    ppl, nll, n = evaluate_ppl(
        info, params, tokenizer, text, chunk=args.chunk, max_tokens=args.max_tokens
    )
    print(f"tokens={n} nll={nll:.4f} ppl={ppl:.3f}")
    return ppl, nll, n


if __name__ == "__main__":
    main()
