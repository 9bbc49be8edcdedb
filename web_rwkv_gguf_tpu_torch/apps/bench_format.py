"""Format comparison benchmark: file size / load time / RAM / prefill /
generation across model formats (ref: examples/bench_format.rs — warmup 2
runs, 5 measured, prefill 256, gen 64).

Each file loads through ``apps.common.load_any_model``; the prefill is one
``forward_chunk`` of B = 1, T = ``--prefill-tokens`` from a fresh state,
the generation a greedy step (``forward_chunk`` at T = 1, ``logits_head``,
argmax) ``--gen-tokens`` times; the median of ``--runs`` timings after
``--warmup``, from the host's clock with the device synchronised
(``utils.trace.device_sync``). The forward runs eagerly, so its time
includes the host's launch of every kernel."""

from __future__ import annotations

import argparse
import resource
import time
from pathlib import Path

import numpy as np

from . import common
from ..utils.trace import device_sync


def _rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def bench_one(path, args):
    import torch

    from ..models import forward_chunk, init_state, logits_head

    size_mb = Path(path).stat().st_size / 1e6
    rss0 = _rss_mb()
    t0 = time.perf_counter()
    ns = argparse.Namespace(**{**vars(args), "model": path})
    info, params = common.load_any_model(ns)
    load_ms = (time.perf_counter() - t0) * 1e3
    rss_mb = _rss_mb() - rss0

    dev = params["emb"].device
    B, T = 1, args.prefill_tokens
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, info.num_vocab, (B, T))).to(dev)
    lens = torch.full((B,), T, device=dev)
    ones = torch.ones(B, dtype=torch.long, device=dev)

    def prefill():
        return forward_chunk(info, params, init_state(info, B, device=dev), tokens, lens)

    def step(state, token):
        x, state = forward_chunk(info, params, state, token, ones)
        return torch.argmax(logits_head(params, x[:, 0]), dim=-1)[:, None], state

    for _ in range(args.warmup):
        x, st = prefill()
        device_sync(x)
    ts = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        x, st = prefill()
        device_sync(x)
        ts.append(time.perf_counter() - t0)
    prefill_tps = T / np.median(ts)

    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    tok, st = step(st, tok)
    device_sync(tok)
    ts = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        for _ in range(args.gen_tokens):
            tok, st = step(st, tok)
        device_sync(tok)
        ts.append(time.perf_counter() - t0)
    gen_tps = args.gen_tokens / np.median(ts)
    return {
        "file": Path(path).name,
        "size_mb": size_mb,
        "load_ms": load_ms,
        "ram_mb": rss_mb,
        "prefill_tps": prefill_tps,
        "gen_tps": gen_tps,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("models", nargs="+", help="model files to compare")
    p.add_argument("--quant", default="none", choices=["none", "int8", "nf4", "sf4"])
    p.add_argument("--quant-layers", type=int, default=None)
    p.add_argument("--lora", action="append", default=[])
    p.add_argument("--token-chunk-size", type=int, default=128)
    p.add_argument("--rescale", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs: the CUDA card (its kernels) or the CPU "
                        "(their plain PyTorch versions)")
    p.add_argument("--vocab", default=None)
    p.add_argument("--prefill-tokens", type=int, default=256)
    p.add_argument("--gen-tokens", type=int, default=64)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--runs", type=int, default=5)
    args = p.parse_args(argv)

    rows = [bench_one(m, args) for m in args.models]
    hdr = f"{'file':30} {'size MB':>8} {'load ms':>8} {'RAM MB':>8} {'prefill t/s':>12} {'gen t/s':>9}"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(
            f"{r['file']:30} {r['size_mb']:8.1f} {r['load_ms']:8.0f} "
            f"{r['ram_mb']:8.1f} {r['prefill_tps']:12.0f} {r['gen_tps']:9.1f}"
        )
    return rows


if __name__ == "__main__":
    main()
