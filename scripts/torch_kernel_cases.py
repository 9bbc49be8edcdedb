#!/usr/bin/env python3
"""Chosen kernel cases of chip_smoke.py on the card, for one or more
checkouts in turn.

Each case is one of chip_smoke's (its ``MODEL_CASES`` builders, the same
shapes, seeds and tolerances): the kernel is held against its plain
version, then timed in a CUDA graph beside the library call, as
chip_smoke's kernel phase does. From the repo root:

    python3 scripts/torch_kernel_cases.py [--roots A,B,...] [--match 's|...'] \
        [--stacks Q4_K,Q6_K,...] [--batches 4,1,16] [tags]

``tags``: models of ``chip_smoke.MODELS`` whose cases to take (default
all); ``--match``: keep the cases whose name contains one of the given
substrings; ``--roots``: run the cases in each of these checkouts (each
builds its own kernels), in the order given, e.g. ``_archive/parent,.,.,
_archive/parent`` to compare two versions on one card in turns.
``--stacks``: whole-stack RWKV-7 decode cases (``layer_scan7``) at the
0.1B widths at full depth, one per form (GGML block types, ``INT8`` for
an f16 file requantized at load, ``BF16`` for one loaded as it is; see
``STACK_FORMS``) and each of ``--batches`` lanes: chip_smoke's
``mega_case`` (held layer by layer against the plain version, then timed
in a graph), with its per-phase µs. The files are built once, in worker
processes, into ``ops/cuda/_build/stacks/`` of the checkout the script
runs from, and every root reads them there; no model case runs unless
``tags`` are given too. Prints one line per case and, last, one JSON
line of every result.
"""

import json
import os
import subprocess
import sys

# the stack forms: block type (None: an f16 file) and the load's requant
STACK_FORMS = {"Q4_K": ("Q4_K", None), "Q5_K": ("Q5_K", None), "Q6_K": ("Q6_K", None),
               "Q3_K": ("Q3_K", None), "Q4_1": ("Q4_1", None), "Q2_K": ("Q2_K", None),
               "Q8_0": ("Q8_0", None), "INT8": (None, "INT8"), "BF16": (None, None)}
STACK_SEED = 120
STACK_LANES = 16  # the random state's lanes; a case at B takes the first B


def stack_file_path(stack_dir, form):
    return os.path.join(stack_dir, f"v7-{form}-{STACK_SEED}.gguf")


def build_stack_file(stack_dir, form):
    """Write the RWKV-7 0.1B file of ``form`` (chip_smoke's slot-stack
    widths: full depth, a vocabulary of 256) unless it is there."""
    path = stack_file_path(stack_dir, form)
    if os.path.exists(path):
        return path
    import numpy as np

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
    from web_rwkv_gguf_tpu_torch.utils import synthetic

    kind, _ = STACK_FORMS[form]
    placement = dict(dtype=np.float16) if kind is None else dict(quantize=GgmlDType[kind])
    raw = synthetic.make_v7_gguf(**cs.SLOT_WIDTHS["v7"], seed=STACK_SEED, **placement)
    with open(path + ".tmp", "wb") as f:
        f.write(bytes(raw))
    os.replace(path + ".tmp", path)
    return path


def build_stack_files(stack_dir, forms):
    """Every form's file, built in parallel worker processes."""
    import multiprocessing

    os.makedirs(stack_dir, exist_ok=True)
    with multiprocessing.get_context("spawn").Pool(min(len(forms), 7)) as pool:
        pool.starmap(build_stack_file, [(stack_dir, f) for f in forms])


def stack_cases(torch, stack_dir, forms, batches, bf16_peak, f32_peak):
    """chip_smoke ``mega_case`` cases of the whole-stack RWKV-7 kernel: each
    form's stack on a random state (numpy, seeded: the same inputs in every
    checkout) at each of ``batches`` lanes (lane 2 frozen at B=4, as
    chip_smoke's hold_stack does)."""
    import numpy as np

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch import models
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7
    from web_rwkv_gguf_tpu_torch.quant import QuantScheme

    cases = []
    for form in forms:
        with open(stack_file_path(stack_dir, form), "rb") as f:
            raw = f.read()
        quant = STACK_FORMS[form][1]
        info, params = models.load_model(
            GgufFile(raw), quant=QuantScheme[quant] if quant else None, device="cuda")
        mega = models.prepare_decode(params, info, 4)["mega7"]
        L, C, H = info.num_layer, info.num_emb, info.num_head
        rng = np.random.default_rng(STACK_SEED)
        f = lambda *s: torch.from_numpy(  # noqa: E731
            (rng.standard_normal(s) * 0.5).astype(np.float32)).cuda()
        state = {"att_shift": f(L, STACK_LANES, C), "wkv": f(L, STACK_LANES, H, 64, 64),
                 "ffn_shift": f(L, STACK_LANES, C)}
        toks = torch.arange(STACK_LANES, device="cuda")[:, None] * 7 + 1
        dec_x = models.embed_tokens(params, toks)[:, 0]
        for B in batches:
            mask = (torch.tensor([1.0, 1.0, 0.0, 1.0], device="cuda") if B == 4
                    else torch.ones(B, device="cuda"))
            case = cs.mega_case(torch, layer7, mega,
                                {k: v[:, :B].contiguous() for k, v in state.items()},
                                dec_x[:B].contiguous(), mask, (LN_EPS, GN_EPS, L2_EPS),
                                bf16_peak, f32_peak, f"stack {form}")
            cases.append(case)
    return cases


def phase_us(torch, case, n_phases, reps=5):
    """µs per layer by phase (the device clock after each grid barrier),
    median of ``reps`` launches."""
    L = case["L"]
    stamps = []
    for _ in range(reps):
        ns = torch.zeros(1 + n_phases * L, dtype=torch.int64, device="cuda")
        case["kernel"](*case["make_args"](0), phase_ns=ns)
        stamps.append(ns.diff().view(L, n_phases).double().mean(0) / 1e3)
    return torch.stack(stamps).median(0).values.tolist()


def run_here(tags, match, stacks=(), batches=(), stack_dir=None):
    """The cases of this checkout (the working directory)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch import runtime
    from web_rwkv_gguf_tpu_torch.ops.cuda import build, layer7, matmul, wkv4, wkv6, wkv7
    from web_rwkv_gguf_tpu_torch.runtime.engine import _bucket

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_cases: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    hbm, bf16_peak, f32_peak = cs.peaks(torch.cuda.get_device_name(0))
    if not match and (tags or not stacks):  # all at once, in parallel; else at first use
        build.build(("q4k_gemv", "q6k_gemv", "qs_gemv", "qkb_gemv", "nf4_gemv", "gemv_grouped",
                     "qk_gemm", "att_core7", "wkv7_scan", "wkv6_scan", "wkv4_scan"))
    rng = np.random.default_rng(cs.ENGINE_SEED)
    [rng.integers(0, cs.VOCAB, n) for n in cs.ENGINE_LENGTHS]  # chip_smoke's draws, in order
    _, _, full_rows = cs.full_input(runtime, _bucket, rng, cs.VOCAB)
    kmods = {"matmul": matmul, "wkv7": wkv7, "wkv6": wkv6, "wkv4": wkv4}
    out, seen = [], set()
    for case in (stack_cases(torch, stack_dir, stacks, batches, bf16_peak, f32_peak)
                 if stacks else ()):
        try:
            fields = cs.run_kernel_case(torch, case, hbm)
            fields["phase_us"] = phase_us(torch, case, len(layer7.PHASES))
            print(f"{case['name']}: µs per layer by phase: " + ", ".join(
                f"{n} {t:.2f}" for n, t in zip(layer7.PHASES, fields["phase_us"])), flush=True)
        except AssertionError as e:
            fields = {"failed": str(e)}
        out.append({"name": case["name"], **fields})
        torch.cuda.empty_cache()
    for tag in tags or ([] if stacks else list(cs.MODELS)):
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
    opts = {"--roots": None, "--match": None, "--stacks": None, "--batches": None,
            "--stack-dir": None}
    for key in opts:
        if key in args:
            i = args.index(key)
            opts[key] = args[i + 1].split("|" if key == "--match" else ",")
            del args[i:i + 2]
    one = "--one" in args
    tags = [a for a in args if a != "--one"]
    match = opts["--match"] or []
    stacks = opts["--stacks"] or []
    if any(f not in STACK_FORMS for f in stacks):
        raise SystemExit(f"torch_kernel_cases: stack forms are named from {list(STACK_FORMS)}")
    batches = [int(b) for b in opts["--batches"] or ("4", "1", "16")]
    stack_dir = (opts["--stack-dir"] or [os.path.abspath(os.path.join(
        "web_rwkv_gguf_tpu_torch", "ops", "cuda", "_build", "stacks"))])[0]
    if stacks and not one:
        sys.path.insert(0, os.getcwd())
        build_stack_files(stack_dir, stacks)
    if one or opts["--roots"] is None:
        results = run_here(tags, match, stacks, batches, stack_dir)
        print(json.dumps({"root": os.getcwd(), "cases": results}), flush=True)
        return 0
    here = os.path.abspath(__file__)
    summary = []
    for root in opts["--roots"]:
        cmd = [sys.executable, here, "--one", *tags]
        if match:
            cmd += ["--match", "|".join(match)]
        if stacks:
            cmd += ["--stacks", ",".join(stacks), "--batches", ",".join(map(str, batches)),
                    "--stack-dir", stack_dir]
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
                  f"{'' if lib is None else f', library {lib * 1e3:.4f} us'}{ratio}, bound "
                  f"{c['bound_ms'] * 1e3:.4f} us"
                  + ("" if "phase_us" not in c else ", µs per layer by phase "
                     + " / ".join(f"{t:.2f}" for t in c["phase_us"])))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
