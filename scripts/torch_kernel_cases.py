#!/usr/bin/env python3
"""Chosen kernel cases of chip_smoke.py on the card, for one or more
checkouts in turn.

Each case is one of chip_smoke's (its ``MODEL_CASES`` builders, the same
shapes, seeds and tolerances): the kernel is held against its plain
version, then timed in a CUDA graph beside the library call, as
chip_smoke's kernel phase does. From the repo root:

    python3 scripts/torch_kernel_cases.py [--roots A,B,...] [--match 's|...'] \
        [--stacks Q4_K,Q6_K,...] [--batches 4,1,16] [--time-only R,...] [tags]

``tags``: models of ``chip_smoke.MODELS`` whose cases to take (default
all); ``--match``: keep the cases whose name contains one of the given
substrings; ``--roots``: run the cases in each of these checkouts (each
builds its own kernels), in the order given, e.g. ``_archive/parent,.,.,
_archive/parent`` to compare two versions on one card in turns.
``--time-only``: roots (of ``--roots``) whose cases are timed without
the comparison, for a variant with parts of a kernel switched off (its
outputs are wrong by design; ``max_abs_err`` reads NaN); without
``--roots``, this checkout's cases are timed so.
``--stacks``: whole-stack decode cases at each of ``--batches`` lanes:
RWKV-7 (``layer_scan7``, row 4) at the 0.1B widths at full depth, one per
form (GGML block types, ``INT8`` for an f16 file requantized at load,
``BF16`` for one loaded as it is; see ``STACK_FORMS``), and RWKV-6, -5
and -4 (``layer_scan56``, row 13) named ``v6-Q4_K`` and so on (see
``STACKS56``: the 1.6B, 0.4B and 0.1B widths): chip_smoke's ``mega_case``
(held layer by layer against the plain version, then timed in a graph),
with its per-phase µs (the phases of the checkout's own ``PHASES``) and,
for RWKV-7, a digest of the whole launch's outputs (x and the new state,
bit for bit) on the case's inputs, which are the same in every checkout
(a random state from numpy, seeded), so that two checkouts' outputs
compare in one call. The files are built once, in worker processes, into
``ops/cuda/_build/stacks/`` of the checkout the script runs from, and
every root reads them there; no model case runs unless ``tags`` are
given too. Prints one line per case and, last, one JSON line of every
result.
"""

import json
import os
import subprocess
import sys

# the stack forms: block type (None: an f16 file) and the load's requant
STACK_FORMS = {"Q4_K": ("Q4_K", None), "Q5_K": ("Q5_K", None), "Q6_K": ("Q6_K", None),
               "Q3_K": ("Q3_K", None), "Q4_1": ("Q4_1", None), "Q2_K": ("Q2_K", None),
               "Q8_0": ("Q8_0", None), "INT8": (None, "INT8"), "BF16": (None, None)}
# RWKV-6, -5 and -4 stacks: (version, block type, requant, layers); the
# widths of chip_smoke's v6, v5 and v4 models (World 1.6B, 0.4B, 0.1B),
# the 1.6B ones at full depth in Q4_K and Q8_0, 6 layers requantized to
# Int8 and 4 in the slot forms no V6 model reaches (as chip_smoke's slot
# stacks)
STACKS56 = {"v6-Q4_K": (6, "Q4_K", None, 24), "v6-Q8_0": (6, "Q8_0", None, 24),
            "v6-INT8": (6, None, "INT8", 6), "v6-Q6_K": (6, "Q6_K", None, 4),
            "v6-Q4_0": (6, "Q4_0", None, 4), "v6-BF16": (6, None, None, 4),
            "v5-Q4_K": (5, "Q4_K", None, 24), "v4-Q4_K": (4, "Q4_K", None, 12)}
STACK_SEED = 120
STACK_LANES = 16  # the random state's lanes; a case at B takes the first B


def stack_file_path(stack_dir, form):
    name = form if form in STACKS56 else f"v7-{form}"
    return os.path.join(stack_dir, f"{name}-{STACK_SEED}.gguf")


def build_stack_file(stack_dir, form):
    """Write the file of stack ``form`` (RWKV-7: chip_smoke's slot-stack
    widths at full depth; RWKV-6, -5, -4: STACKS56; a vocabulary of 256)
    unless it is there."""
    path = stack_file_path(stack_dir, form)
    if os.path.exists(path):
        return path
    import numpy as np

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
    from web_rwkv_gguf_tpu_torch.utils import synthetic

    if form in STACKS56:
        version, kind, _, layers = STACKS56[form]
        widths = {**cs.MODELS[f"v{version}"]["widths"], "n_layer": layers, "n_vocab": 256}
    else:
        (kind, _), version, widths = STACK_FORMS[form], 7, cs.SLOT_WIDTHS["v7"]
    placement = dict(dtype=np.float16) if kind is None else dict(quantize=GgmlDType[kind])
    raw = getattr(synthetic, f"make_v{version}_gguf")(**widths, seed=STACK_SEED, **placement)
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
    """chip_smoke ``mega_case`` cases of the whole-stack kernels: each
    form's stack on a random state (numpy, seeded: the same inputs in every
    checkout; RWKV-4's pp above its F32_MIN sentinel and bb positive) at
    each of ``batches`` lanes (lane 2 frozen at B=4, as chip_smoke's
    hold_stack does), each case with its phases' names."""
    import numpy as np

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch import models
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7, layer56
    from web_rwkv_gguf_tpu_torch.quant import QuantScheme

    cases = []
    for form in forms:
        with open(stack_file_path(stack_dir, form), "rb") as f:
            raw = f.read()
        v7 = form not in STACKS56
        quant = STACK_FORMS[form][1] if v7 else STACKS56[form][2]
        info, params = models.load_model(
            GgufFile(raw), quant=QuantScheme[quant] if quant else None, device="cuda")
        mega = models.prepare_decode(params, info, 4)["mega7" if v7 else "mega56"]
        L, C, H = info.num_layer, info.num_emb, info.num_head
        rng = np.random.default_rng(STACK_SEED)
        f = lambda *s: torch.from_numpy(  # noqa: E731
            (rng.standard_normal(s) * 0.5).astype(np.float32)).cuda()
        state = {"att_shift": f(L, STACK_LANES, C), "ffn_shift": f(L, STACK_LANES, C)}
        if v7 or mega["version"] != 4:
            state["wkv"] = f(L, STACK_LANES, H, 64, 64)
        else:
            state.update(aa=f(L, STACK_LANES, C), bb=f(L, STACK_LANES, C).abs() + 0.1,
                         pp=f(L, STACK_LANES, C))
        toks = torch.arange(STACK_LANES, device="cuda")[:, None] * 7 + 1
        dec_x = models.embed_tokens(params, toks)[:, 0]
        mod = layer7 if v7 else layer56
        eps = (LN_EPS, GN_EPS, L2_EPS) if v7 else (LN_EPS, GN_EPS)
        for B in batches:
            mask = (torch.tensor([1.0, 1.0, 0.0, 1.0], device="cuda") if B == 4
                    else torch.ones(B, device="cuda"))
            case = cs.mega_case(torch, mod, mega,
                                {k: v[:, :B].contiguous() for k, v in state.items()},
                                dec_x[:B].contiguous(), mask, eps, bf16_peak, f32_peak,
                                f"stack {form}")
            case["phases"] = layer7.PHASES if v7 else layer56.PHASES[mega["version"]]
            case["digest"] = v7
            cases.append(case)
    return cases


def digest(torch, case):
    """sha256 (16 hex digits) of one launch's outputs on the case's first
    inputs: x and the new state, their bytes in order."""
    import hashlib

    x, state = case["kernel"](*case["make_args"](0))
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in (x, *(state[k] for k in sorted(state))):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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


def run_here(tags, match, stacks=(), batches=(), stack_dir=None, time_only=False):
    """The cases of this checkout (the working directory); ``time_only``:
    timed without the comparison."""
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
    # the fixed cost of a launch as the cases are timed: an empty one (a
    # one-element fill), 64 to a graph
    one = torch.zeros(1, device="cuda")
    empty_ms = cs.time_graph(torch, [one.zero_] * 64, reps=20)
    print(f"empty launch: {empty_ms * 1e3:.4f} us in a graph", flush=True)
    out.append({"name": "empty launch", "ms": empty_ms})
    for case in (stack_cases(torch, stack_dir, stacks, batches, bf16_peak, f32_peak)
                 if stacks else ()):
        try:
            fields = cs.run_kernel_case(torch, case, hbm)
            fields["phase_us"] = phase_us(torch, case, len(case["phases"]))
            fields["phases"] = list(case["phases"])
            if case["digest"]:
                fields["digest"] = digest(torch, case)
            print(f"{case['name']}: µs per layer by phase: " + ", ".join(
                f"{n} {t:.2f}" for n, t in zip(case["phases"], fields["phase_us"]))
                + (f"; outputs {fields['digest']}" if "digest" in fields else ""), flush=True)
        except AssertionError as e:
            fields = {"failed": str(e)}
        out.append({"name": case["name"], **fields})
        torch.cuda.empty_cache()
    for tag in tags or ([] if stacks else list(cs.MODELS)):
        for case in cs.MODEL_CASES[tag](torch, kmods, bf16_peak, f32_peak, full_rows):
            if case["name"] in seen or (match and not any(s in case["name"] for s in match)):
                continue
            seen.add(case["name"])
            if time_only:
                case = {**case, "check": lambda args: (0.0, 0.0)}
            try:
                fields = cs.run_kernel_case(torch, case, hbm)
            except AssertionError as e:  # logged; the other cases still run
                fields = {"failed": str(e)}
            if time_only and "failed" not in fields:
                fields["max_abs_err"] = float("nan")
            out.append({"name": case["name"], **fields})
            torch.cuda.empty_cache()
    return out


def main():
    args = sys.argv[1:]
    opts = {"--roots": None, "--match": None, "--stacks": None, "--batches": None,
            "--stack-dir": None, "--time-only": None}
    for key in opts:
        if key in args:
            i = args.index(key)
            opts[key] = args[i + 1].split("|" if key == "--match" else ",")
            del args[i:i + 2]
    one = "--one" in args
    tags = [a for a in args if a != "--one"]
    match = opts["--match"] or []
    stacks = opts["--stacks"] or []
    if any(f not in STACK_FORMS and f not in STACKS56 for f in stacks):
        raise SystemExit(f"torch_kernel_cases: stacks are named from {list(STACK_FORMS)} "
                         f"and {list(STACKS56)}")
    batches = [int(b) for b in opts["--batches"] or ("4", "1", "16")]
    stack_dir = (opts["--stack-dir"] or [os.path.abspath(os.path.join(
        "web_rwkv_gguf_tpu_torch", "ops", "cuda", "_build", "stacks"))])[0]
    if stacks and not one:
        sys.path.insert(0, os.getcwd())
        build_stack_files(stack_dir, stacks)
    if one or opts["--roots"] is None:
        results = run_here(tags, match, stacks, batches, stack_dir,
                           opts["--time-only"] is not None)
        print(json.dumps({"root": os.getcwd(), "cases": results}), flush=True)
        return 0
    here = os.path.abspath(__file__)
    summary = []
    for root in opts["--roots"]:
        cmd = [sys.executable, here, "--one", *tags]
        if root in (opts["--time-only"] or ()):
            cmd += ["--time-only", root]
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
            if c["name"] == "empty launch":
                print(f"{run['root']}: empty launch: {c['ms'] * 1e3:.4f} us")
                continue
            if "failed" in c:
                print(f"{run['root']}: {c['name']}: FAILED: {c['failed']}")
                continue
            lib = c["library_ms"]
            ratio = "" if lib is None else f", kernel / library {c['ms'] / lib:.3f}"
            print(f"{run['root']}: {c['name']}: {c['ms'] * 1e3:.4f} us"
                  f"{'' if lib is None else f', library {lib * 1e3:.4f} us'}{ratio}, bound "
                  f"{c['bound_ms'] * 1e3:.4f} us"
                  + ("" if "phase_us" not in c else ", µs per layer by phase "
                     + " / ".join(f"{t:.2f}" for t in c["phase_us"]))
                  + ("" if "digest" not in c else f", outputs {c['digest']}"))
    digests = {}  # the whole-stack RWKV-7 outputs of every root, by case
    for run in summary:
        for c in run["cases"]:
            if "digest" in c:
                digests.setdefault(c["name"], set()).add(c["digest"])
    for name, seen in digests.items():
        print(f"{name}: outputs {'the same in every root' if len(seen) == 1 else 'DIFFER'} "
              f"({', '.join(sorted(seen))})")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
