"""Shared app plumbing: model/tokenizer loading, the device and sampler flags."""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

DEFAULT_VOCAB_PATHS = [
    os.environ.get("RWKV_VOCAB", ""),
    "assets/vocab/rwkv_vocab_v20230424.json",
]


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", required=True, help=".gguf / .st / .rwkvz model file")
    p.add_argument("--vocab", default=None, help="tokenizer vocab JSON")
    p.add_argument(
        "--quant", default="none", choices=["none", "int8", "nf4", "sf4"],
        help="engine requantization for unquantized sources",
    )
    p.add_argument("--quant-layers", type=int, default=None,
                   help="only requantize the first N layers")
    p.add_argument("--lora", action="append", default=[],
                   help="LoRA file to merge at load (repeatable)")
    p.add_argument("--token-chunk-size", type=int, default=128)
    p.add_argument("--rescale", type=int, default=None,
                   help="halve residual every N layers (parity option)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs: the CUDA card (its kernels) or the CPU "
                        "(their plain PyTorch versions)")


def add_sampler_args(p: argparse.ArgumentParser):
    p.add_argument("--sampler", default="nucleus", choices=["nucleus", "typical", "greedy"])
    p.add_argument("--top-p", type=float, default=0.5)
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)


def make_sampler(args):
    from ..utils.sampling import GreedySampler, NucleusSampler, TypicalSampler

    if args.sampler == "greedy":
        return GreedySampler()
    if args.sampler == "typical":
        return TypicalSampler(args.tau, args.temp, args.seed)
    return NucleusSampler(args.top_p, args.temp, args.seed)


def load_tokenizer(vocab_path=None):
    from ..utils.tokenizer import Tokenizer

    paths = [vocab_path] if vocab_path else DEFAULT_VOCAB_PATHS
    for p in paths:
        if p and Path(p).exists():
            return Tokenizer.from_file(p)
    raise FileNotFoundError(
        "no tokenizer vocab found; pass --vocab or set RWKV_VOCAB"
    )


def device(args) -> str:
    """``args.device``; raises where it is ``cuda`` and there is no card
    (an app never carries on on the CPU unasked)."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card here; pass --device cpu to run on "
                           "the CPU")
    return args.device


def load_any_model(args):
    """Load .gguf / .st / .rwkvz per extension onto ``args.device``;
    returns (info, params)."""
    from ..models import LoraPatch, load_model
    from ..quant import QuantScheme

    dev = device(args)
    path = Path(args.model)
    t0 = time.perf_counter()
    if path.suffix == ".rwkvz":
        from ..io import load_model_snapshot

        info, params = load_model_snapshot(path, device=dev)
    else:
        if path.suffix in (".st", ".safetensors"):
            from ..io import SafetensorsFile

            reader = SafetensorsFile(path)
        else:
            from ..gguf import GgufFile

            reader = GgufFile(path)

        scheme = QuantScheme(args.quant)
        quant = None
        if scheme != QuantScheme.NONE:
            if args.quant_layers is None:
                quant = scheme
            else:
                quant = {i: scheme for i in range(args.quant_layers)}

        lora = []
        for lp in args.lora:
            from ..io import SafetensorsFile

            lora.append(LoraPatch(SafetensorsFile(lp), blend=[(r".+", 1.0)]))
        info, params = load_model(
            reader, quant=quant, lora=lora, rescale=args.rescale, device=dev
        )
    dt = time.perf_counter() - t0
    print(f"loaded {path.name}: {info.version.value} L={info.num_layer} "
          f"C={info.num_emb} V={info.num_vocab} in {dt*1e3:.0f} ms")
    return info, params
