#!/usr/bin/env python3
"""Device time of chip_smoke.py's Engine phases, by kernel, for one or
more checkouts on one card.

For each model of ``chip_smoke.MODELS`` named (default all) it loads the
model's file (built once, by chip_smoke's own ``build_file`` in worker
processes, and shared by every checkout), runs chip_smoke's Engine at B=4
(the four prompts, chunked prefill, one token) and profiles it as
chip_smoke's "profile" lines do: device µs per prompt token, the
dequant-GEMM's (``qk_gemm_kernel``) µs per prompt token and share of it,
and the same for the WKV chunk scans (``wkv7_scan_kernel``,
``wkv6_scan_kernel``, ``wkv4_scan_kernel``);
then the decode segment of 32 steps: device µs and ms per step. From the
repo root:

    python3 scripts/torch_prefill_profile.py [--roots A,B,...] [tags]

``--roots``: checkouts to run in turn (each builds its own kernels), e.g.
``_archive/parent,.`` for a version before and after a change. The files
go to ``_archive/profile_files/`` (gitignored). Prints one line per model
and checkout and, last, one JSON line of every result.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import time

FILES = os.path.join("_archive", "profile_files")


def run_here(tags, files):
    """The Engine phases of each model in this checkout (the working
    directory)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch import models, runtime
    from web_rwkv_gguf_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_prefill_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    rng = np.random.default_rng(cs.ENGINE_SEED)
    prompts = [[int(t) for t in rng.integers(0, cs.VOCAB, n)] for n in cs.ENGINE_LENGTHS]
    n_pre = sum(cs.ENGINE_LENGTHS)
    out = []
    for tag in tags:
        with open(os.path.join(files, f"{tag}.gguf"), "rb") as f:
            raw = f.read()
        info, params = cs.load(models, raw, cs.MODELS[tag], "cuda")
        del raw
        eng = runtime.Engine(info, params, num_batch=len(cs.ENGINE_LENGTHS),
                             token_chunk_size=cs.ENGINE_CHUNK, device="cuda")
        busy, _, rows = cs.profile(
            torch, lambda: (eng.reset_state(), eng.generate(prompts, 1)), n_pre)
        gemm = sum(us for us, key, _ in rows if "qk_gemm_kernel" in key)
        scans = sum(us for us, key, _ in rows
                    if any(f"wkv{v}_scan_kernel" in key for v in (7, 6, 4)))
        eng.reset_state()
        first, gen = eng._gen_prefill(prompts, 0.0, 0, 0.0, 0)
        steps = 32
        segment = models.make_generator(info, steps=steps)
        state = eng.state
        segment(eng.params, state, first, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segment(eng.params, state, first, None)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) / steps * 1e3
        dec_busy, _, _ = cs.profile(torch, lambda: segment(eng.params, state, first, None), steps)
        row = {"tag": tag, "prefill_device_us_per_token": busy, "qk_gemm_us_per_token": gemm,
               "qk_gemm_share": gemm / busy if busy else None,
               "wkv_scan_us_per_token": scans, "wkv_scan_share": scans / busy if busy else None,
               "decode_ms_per_step": ms_step,
               "decode_device_us_per_step": dec_busy}
        print(json.dumps(row), flush=True)
        out.append(row)
        del eng, info, params, segment, state, first, gen
        torch.cuda.empty_cache()
    return out


def build_one(tag):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    raw, _ = cs.build_file(tag, cs.MODELS[tag]["widths"]["n_layer"], cs.MODELS[tag]["seed"])
    with open(os.path.join(FILES, f"{tag}.gguf"), "wb") as f:
        f.write(bytes(raw))
    return tag


def main():
    args = sys.argv[1:]
    roots = None
    if "--roots" in args:
        i = args.index("--roots")
        roots = args[i + 1].split(",")
        del args[i:i + 2]
    if "--one" in args:  # a checkout's run: files at the given directory
        i = args.index("--one")
        files = args[i + 1]
        del args[i:i + 2]
        print(json.dumps({"root": os.getcwd(), "models": run_here(args, files)}), flush=True)
        return 0
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    tags = args or list(cs.MODELS)
    os.makedirs(FILES, exist_ok=True)
    with multiprocessing.get_context("spawn").Pool(5) as pool:
        t0 = time.perf_counter()
        pool.map(build_one, tags)
    print(f"model files built in {time.perf_counter() - t0:.1f} s", flush=True)
    files = os.path.abspath(FILES)
    here = os.path.abspath(__file__)
    summary = []
    for root in roots or ["."]:
        proc = subprocess.run([sys.executable, here, "--one", files, *tags], cwd=root,
                              capture_output=True, text=True)
        print(f"==== {root} (exit {proc.returncode})", flush=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], flush=True)
            return proc.returncode
        summary.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
