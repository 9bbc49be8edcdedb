#!/usr/bin/env python3
"""Time variants of the Q4_K / Q6_K gemv body (``csrc/qgemv_mma.cuh``,
rows 1-2) against each other on the card, in one process.

A variant is the committed source with some of the header's
``constexpr int kName = value;`` constants replaced. Each is built from
a copy of ``csrc/`` into ``ops/cuda/_build/probe/<variant>/``
(gitignored), all at once, and bound in place of ``q4k_gemv`` and
``q6k_gemv`` in turn. Every variant runs the same ``chip_smoke.py``
kernel cases (held against the plain version, then timed in a CUDA graph
over rotated copies), in the order given, so one call's numbers compare
on one card. From the repo root:

    python3 scripts/torch_gemv_probe.py [--match 's|...'] base kMmaRing=3 \\
        kMmaRing=3,kMmaMinBlocks=3 base

``base`` is the committed source; ``--match`` keeps the cases whose name
contains one of the given substrings (default ``q4k_gemv|q6k_gemv``);
``--shape q4k:MxKxN`` (or ``q6k:``, repeatable) adds a case of that
shape on random operands, as chip_smoke builds them. A variant may also
switch parts of the body off (``off=compute+scales``, see ``PARTS``) to
see what each costs; such a variant computes garbage, so its cases are
timed without the comparison (as every case is with ``--time-only``).
Prints each variant's registers and spills (``-Xptxas -v``), one line per
case and variant, and last one JSON line of every result.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys


# parts of the body a variant can switch off: (pattern, replacement) on
# qgemv_mma.cuh
PARTS = {
    # the unit's products and scales: only the copies and the ring remain
    "compute": (r"(auto pairs = \[&\]\(auto&& body\) \{)", r"\1\n        if (a.m > 0) return;"),
    # the scale copies of a unit (both forms)
    "scales": (r"cp_async4\(ss \+ r \* kScl \+ piece \* 4, [^;]+;|"
               r"if \(lane < 16\)\s+cp_async8\([^;]+;\s+else\s+cp_async4\([^;]+;", ";"),
    # the code copies of a unit
    "codes": (r"cp_async16\(st \+ r \* kUnitBytes[^;]+;", ";"),
    # x staging (and Q4_K's group sums)
    "x": (r"for \(int i0 = threadIdx.x; i0 < total;", "for (int i0 = total; i0 < total;"),
}


def variant_sources(build, name, spec):
    """A copy of csrc/ with the constants of ``spec`` ("kA=1,kB=2") set
    and the parts of ``off=a+b`` switched off."""
    out = build.BUILD_DIR / "probe" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    header = out / "qgemv_mma.cuh"
    text = header.read_text()
    for item in spec.split(","):
        key, value = item.split("=")
        if key == "off":
            for part in value.split("+"):
                text, hits = re.subn(*PARTS[part], text)
                if not hits:
                    raise SystemExit(f"torch_gemv_probe: part {part} not found")
            continue
        text, hits = re.subn(rf"(constexpr int {key} = )[^;]+;", rf"\g<1>{value};", text)
        if hits != 1:
            raise SystemExit(f"torch_gemv_probe: no constant {key} in qgemv_mma.cuh")
    header.write_text(text)
    return out


def bind(lib_q4, lib_q6):
    q4, q6 = lib_q4.q4k_gemv, lib_q6.q6k_gemv
    q4.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    q6.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    q4.restype = q6.restype = ctypes.c_int
    return q4, q6


def registers(report):
    """(kernel template arguments, the ptxas line of registers) pairs."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            args = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)E", name)
            tag = f"N={args.group(1)},form={args.group(2)},split={args.group(3)}" if args else name
            rows.append((tag, line.strip()))
    return rows


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch import runtime
    from web_rwkv_gguf_tpu_torch.ops.cuda import build, matmul as mm, wkv4, wkv6, wkv7
    from web_rwkv_gguf_tpu_torch.runtime.engine import _bucket

    args = sys.argv[1:]
    match = ["q4k_gemv", "q6k_gemv"]
    if "--match" in args:
        i = args.index("--match")
        match = args[i + 1].split("|")
        del args[i:i + 2]
    shapes = []
    while "--shape" in args:
        i = args.index("--shape")
        form, dims = args[i + 1].split(":")
        shapes.append((form, *map(int, dims.split("x"))))
        del args[i:i + 2]
    time_only = "--time-only" in args
    args = [a for a in args if a != "--time-only"]
    variants = args or ["base"]
    if not torch.cuda.is_available():
        raise SystemExit("torch_gemv_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False

    libs, jobs = {}, {}
    base_report = build.build(("q4k_gemv", "q6k_gemv"))
    for spec in dict.fromkeys(variants):
        if spec == "base":
            libs[spec] = bind(build.load("q4k_gemv"), build.load("q6k_gemv"))
            for kname, rep in base_report.items():
                for tag, line in registers(rep):
                    print(f"ptxas base {kname} {tag}: {line}", flush=True)
            continue
        src = variant_sources(build, re.sub(r"[^A-Za-z0-9]+", "_", spec), spec)
        for kname in ("q4k_gemv", "q6k_gemv"):
            out = src / f"lib{kname}.so"
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src / f"{kname}.cu")]
            jobs[(spec, kname)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), out)
    built = {}
    for (spec, kname), (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_gemv_probe: {spec} {kname} failed to build:\n{log[-6000:]}")
        for tag, line in registers(log):
            print(f"ptxas {spec} {kname} {tag}: {line}", flush=True)
        built.setdefault(spec, {})[kname] = ctypes.CDLL(str(out))
    for spec, lib in built.items():
        libs[spec] = bind(lib["q4k_gemv"], lib["q6k_gemv"])

    hbm, bf16_peak, f32_peak = cs.peaks(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(cs.ENGINE_SEED)
    [rng.integers(0, cs.VOCAB, n) for n in cs.ENGINE_LENGTHS]  # chip_smoke's draws, in order
    _, _, full_rows = cs.full_input(runtime, _bucket, rng, cs.VOCAB)
    kmods = {"matmul": mm, "wkv7": wkv7, "wkv6": wkv6, "wkv4": wkv4}
    cases = {}
    for tag in cs.MODELS:
        for case in cs.MODEL_CASES[tag](torch, kmods, bf16_peak, f32_peak, full_rows):
            if any(s in case["name"] for s in match) and case["name"].split("[")[0] in (
                    "q4k_gemv", "q6k_gemv"):
                cases.setdefault(case["name"], case)
    for form, m, k, n in shapes:
        make = {"q4k": cs.q4k_case, "q6k": cs.q6k_case}[form]
        case = make(torch, mm, "gemv", m, k, n, 90000 + m + k + n, bf16_peak)
        cases.setdefault(case["name"], case)
    print(f"{torch.cuda.get_device_name(0)}; {cs.nvidia_smi()}", flush=True)
    results = []
    for spec in variants:
        q4, q6 = libs[spec]
        mm._q4k_fn = lambda q4=q4: q4
        mm._q6k_fn = lambda q6=q6: q6
        for name, case in cases.items():
            if time_only or "off=" in spec:
                sets = [case["make_args"](i) for i in
                        range(max(2, -(-int(cs.L2_FLUSH_BYTES) // case["nbytes"])))]
                fields = {"ms": cs.time_graph(torch, [lambda a=a: case["kernel"](*a) for a in sets]),
                          "bound_ms": case["nbytes"] / hbm * 1e3, "library_ms": float("nan")}
                del sets
            else:
                try:
                    fields = cs.run_kernel_case(torch, case, hbm)
                except AssertionError as e:
                    fields = {"failed": str(e)}
            results.append({"variant": spec, "name": name, **fields})
            torch.cuda.empty_cache()
    for r in results:
        if "failed" in r:
            print(f"{r['variant']}: {r['name']}: FAILED: {r['failed']}")
        else:
            print(f"{r['variant']}: {r['name']}: {r['ms'] * 1e3:.4f} us, bound "
                  f"{r['bound_ms'] * 1e3:.4f} us, library {r['library_ms'] * 1e3:.4f} us")
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
