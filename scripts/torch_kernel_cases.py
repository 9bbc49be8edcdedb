#!/usr/bin/env python3
"""Chosen kernel cases of chip_smoke.py on the card, for one or more
checkouts in turn.

Each case is one of chip_smoke's (its ``MODEL_CASES`` builders, the same
shapes, seeds and tolerances): the kernel is held against its plain
version, then timed in a CUDA graph beside the library call, as
chip_smoke's kernel phase does. From the repo root:

    python3 scripts/torch_kernel_cases.py [--roots A,B,...] [--match 's|...'] [tags]

``tags``: models of ``chip_smoke.MODELS`` whose cases to take (default
all); ``--match``: keep the cases whose name contains one of the given
substrings; ``--roots``: run the cases in each of these checkouts (each
builds its own kernels), in the order given, e.g. ``_archive/parent,.,.,
_archive/parent`` to compare two versions on one card in turns. Prints
one line per case and, last, one JSON line of every result.
"""

import json
import os
import subprocess
import sys


def run_here(tags, match):
    """The cases of this checkout (the working directory)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch import runtime
    from web_rwkv_gguf_tpu_torch.ops.cuda import build, matmul, wkv4, wkv6, wkv7
    from web_rwkv_gguf_tpu_torch.runtime.engine import _bucket

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_cases: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    hbm, bf16_peak, f32_peak = cs.peaks(torch.cuda.get_device_name(0))
    if not match:  # all at once, in parallel; with --match each at first use
        build.build(("q4k_gemv", "q6k_gemv", "qs_gemv", "qkb_gemv", "nf4_gemv", "gemv_grouped",
                     "qk_gemm", "att_core7", "wkv7_scan", "wkv6_scan", "wkv4_scan"))
    rng = np.random.default_rng(cs.ENGINE_SEED)
    [rng.integers(0, cs.VOCAB, n) for n in cs.ENGINE_LENGTHS]  # chip_smoke's draws, in order
    _, _, full_rows = cs.full_input(runtime, _bucket, rng, cs.VOCAB)
    kmods = {"matmul": matmul, "wkv7": wkv7, "wkv6": wkv6, "wkv4": wkv4}
    out, seen = [], set()
    for tag in tags or list(cs.MODELS):
        for case in cs.MODEL_CASES[tag](torch, kmods, bf16_peak, f32_peak, full_rows):
            if case["name"] in seen or (match and not any(s in case["name"] for s in match)):
                continue
            seen.add(case["name"])
            try:
                fields = cs.run_kernel_case(torch, case, hbm)
            except AssertionError as e:  # logged; the other cases still run
                fields = {"failed": str(e)}
            out.append({"name": case["name"], **fields})
            torch.cuda.empty_cache()
    return out


def main():
    args = sys.argv[1:]
    opts = {"--roots": None, "--match": None}
    for key in opts:
        if key in args:
            i = args.index(key)
            opts[key] = args[i + 1].split("|" if key == "--match" else ",")
            del args[i:i + 2]
    one = "--one" in args
    tags = [a for a in args if a != "--one"]
    match = opts["--match"] or []
    if one or opts["--roots"] is None:
        results = run_here(tags, match)
        print(json.dumps({"root": os.getcwd(), "cases": results}), flush=True)
        return 0
    here = os.path.abspath(__file__)
    summary = []
    for root in opts["--roots"]:
        cmd = [sys.executable, here, "--one", *tags]
        if match:
            cmd += ["--match", "|".join(match)]
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
        print(f"==== {root} (exit {proc.returncode})", flush=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], flush=True)
            return proc.returncode
        summary.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for run in summary:
        for c in run["cases"]:
            if "failed" in c:
                print(f"{run['root']}: {c['name']}: FAILED: {c['failed']}")
                continue
            lib = c["library_ms"]
            ratio = "" if lib is None else f", kernel / library {c['ms'] / lib:.3f}"
            print(f"{run['root']}: {c['name']}: {c['ms'] * 1e3:.4f} us"
                  f"{'' if lib is None else f', library {lib * 1e3:.4f} us'}{ratio}")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
