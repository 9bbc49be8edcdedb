#!/usr/bin/env python3
"""Survey of chip_smoke.py's card-vs-CPU decode check over model seeds.

For each model tag and seed it builds the two-layer comparison file of
``chip_smoke.MODELS[tag]`` at that seed, runs chip_smoke's three decode
steps (B=3, lane 2 frozen on the second) on the card and on the CPU,
through the per-layer kernels and through the whole-stack kernel, and
prints per path whether every reading is within chip_smoke's limits,
with the largest logits, layer 1 WKV state and ffn_shift readings. It
shows how far the limits sit from the random weights' rounding chaos
(PERF.md, Findings PR 5). Needs one CUDA card; from the repo root:

    python3 scripts/torch_compare_seeds.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from web_rwkv_gguf_tpu_torch import models  # noqa: E402
from web_rwkv_gguf_tpu_torch.gguf import GgufFile  # noqa: E402
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType  # noqa: E402
from web_rwkv_gguf_tpu_torch.utils import synthetic  # noqa: E402

SURVEY = (("v7q5", range(41, 49)), ("v7", range(1, 9)), ("v6q8", range(51, 55)))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_compare_seeds: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    decode = [(np.array(t)[:, None], np.array(n)) for t, n in cs.COMPARE_STEPS]
    for tag, seeds in SURVEY:
        spec = cs.MODELS[tag]
        for seed in seeds:
            raw = getattr(synthetic, spec["make"])(
                **{**spec["widths"], "n_layer": cs.COMPARE_LAYERS}, seed=seed,
                quantize=GgmlDType[spec["quantize"]],
                head_quantize=GgmlDType[spec["head_quantize"]])
            info, p_card = models.load_model(GgufFile(raw), device="cuda")
            _, p_cpu = models.load_model(GgufFile(raw), device="cpu")
            out = []
            for label, a, b in (("per-layer", p_card, p_cpu),
                                ("stack", models.prepare_decode(p_card, info, 3),
                                 models.prepare_decode(p_cpu, info, 3))):
                card = cs.run_chunks(torch, models, info, a, decode, "cuda")
                cpu = cs.run_chunks(torch, models, info, b, decode, "cpu")
                rel = cs.rel_diff(card, cpu)
                worst = {k: max(r[k] for r in rel) for k in rel[0]}
                ok = all(v <= cs.card_cpu_limit(k) for r in rel for k, v in r.items())
                out.append(f"{label} {'ok' if ok else 'OVER'} logits {worst['logits']:.2e} "
                           f"wkv.1 {worst.get('wkv.1', 0):.2e} "
                           f"ffn_shift {worst['ffn_shift']:.2e}")
            print(tag, seed, " | ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
