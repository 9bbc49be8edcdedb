#!/usr/bin/env python3
"""Time variants of the WKV chunk scans (``csrc/wkv_scan.cuh`` under
``wkv6_scan.cu`` and ``wkv7_scan.cu``, rows 11 and 6) against each other
on the card, in one process.

A variant is the committed source with some of the header's
``constexpr int kName = value;`` constants replaced (``kKpt``, the keys a
thread holds; ``kStages``; ``kTargetBlocks``,
the grid the column split aims for), or parts of the kernels switched
off (``off=compute+stage``, see ``PARTS``), to see what each costs;
``trace`` (alone or with constants, e.g. ``trace,kKpt=16``) prints block
(0, 0)'s clock at its tile events for one launch of each case. Each is built from a copy of
``csrc/`` into ``ops/cuda/_build/probe/<variant>/`` (gitignored), all at
once, and bound in place of ``wkv6_scan`` and ``wkv7_scan`` in turn.
Every variant runs the same ``chip_smoke.py`` scan cases (held against
the plain version, then timed in a CUDA graph over rotated copies), in
the order given, so one call's numbers compare on one card. From the repo
root:

    python3 scripts/torch_scan_probe.py [--match 's|...'] base kKpt=16 \\
        kStages=6,kTargetBlocks=264 off=compute trace base

``base`` is the committed source; ``--match`` keeps the cases whose name
contains one of the given substrings (default every scan case of the
V7, V6 and V5 models). Prints each variant's registers and spills
(``-Xptxas -v``), one line per case and variant, and last one JSON line
of every result.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

KERNELS = ("wkv6_scan", "wkv7_scan")

# parts a variant can switch off: (file, pattern, replacement) edits; such
# a variant computes garbage, so its cases are timed without the comparison
PARTS = {
    # the token loop (the producer's copies and the ring's waits remain)
    "compute": [(f, r"(const auto step = \[&\]\([^)]*\) \{)", r"\1\n    return;")
                for f in ("wkv6_scan.cu", "wkv7_scan.cu")],
    # the producer's copies (the loop computes on whatever the ring holds)
    "stage": [("wkv_scan.cuh", r"mbar_expect_tx\(full \+ s, \(uint32_t\)\([^;]+\);",
               "mbar_expect_tx(full + s, 0u);"),
              ("wkv_scan.cuh", r"if \(staged >> vi & 1\)", "if (false)")],
    # block (0, 0)'s SM clock at its tile events, read back after one launch
    # of each case (`scan_trace`): the start; per tile j, the producer past
    # its wait for the stage (64 + j), consumer warp 0 with the tile landed
    # (128 + j) and done with it (192 + j); the consumers' end (1)
    "trace": [("wkv_scan.cuh", r"namespace wkv_scan \{\n",
               "__device__ long long g_trace[256];\n"
               "#define TRACE(i) if (blockIdx.x == 0 && blockIdx.y == 0) g_trace[i] = clock64();\n"
               "namespace wkv_scan {\n"),
              ("wkv_scan.cuh", r"(if \(j >= kStages\) mbar_wait\(empty \+ s, \(j / kStages - 1\) & 1\);)",
               r"\1\n      if (lane == 0 && j < 64) TRACE(64 + j);"),
              ("wkv_scan.cuh", r"(    mbar_wait\(full \+ j % kStages, \(j / kStages\) & 1\);)",
               r"\1\n    if (threadIdx.x == 0 && j < 64) TRACE(128 + j);"),
              ("wkv_scan.cuh", r"(  __device__ __forceinline__ void release\(int j\) const \{)",
               r"\1\n    if (threadIdx.x == 0 && j < 64) TRACE(192 + j);"),
              ("wkv_scan.cuh", r"(      asm volatile\(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\"\);)",
               r"\1\n      TRACE(0);"),
              ("wkv6_scan.cu", r"(\n  store_state\(S, state_out, bh, me\);)",
               r"\n  if (threadIdx.x == 0) TRACE(1);\1"),
              ("wkv7_scan.cu", r"(\n  store_state\(S, state_out, bh, me\);)",
               r"\n  if (threadIdx.x == 0) TRACE(1);\1"),
              ("wkv6_scan.cu", r"\Z", "\nextern \"C\" int scan_trace(void* dst) {\n"
               "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n"),
              ("wkv7_scan.cu", r"\Z", "\nextern \"C\" int scan_trace(void* dst) {\n"
               "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n")],
    # V6's bonus pass
    "bonus": [("wkv6_scan.cu", r"__shfl_sync\(0xffffffffu, part, 4 \* tt\)", "0.f")],
}


def variant_sources(build, name, spec):
    """A copy of csrc/ with the header constants of ``spec`` ("kA=1,kB=2")
    set and the parts of ``off=a+b`` switched off."""
    out = build.BUILD_DIR / "probe" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    header = out / "wkv_scan.cuh"
    for item in spec.split(","):
        key, value = item.split("=") if "=" in item else ("off", item)  # "trace"
        if key == "off":
            for part in value.split("+"):
                for f, pattern, repl in PARTS[part]:
                    text, hits = re.subn(pattern, repl, (out / f).read_text())
                    if not hits:
                        raise SystemExit(f"torch_scan_probe: part {part} not found in {f}")
                    (out / f).write_text(text)
            continue
        text, hits = re.subn(rf"(constexpr int {key} = )[^;]+;", rf"\g<1>{value};",
                             header.read_text())
        if hits != 1:
            raise SystemExit(f"torch_scan_probe: no constant {key} in wkv_scan.cuh")
        header.write_text(text)
    return out


def trace(torch, case, lib):
    """One launch of the case; block (0, 0)'s tile events (see PARTS'
    "trace"), in SM cycles after its start."""
    import numpy as np

    args = case["make_args"](0)
    torch.cuda.synchronize()
    case["kernel"](*args)
    torch.cuda.synchronize()
    buf = np.zeros(256, np.int64)
    lib.scan_trace.argtypes = [ctypes.c_void_p]
    if lib.scan_trace(buf.ctypes.data):
        return "trace not read"
    t0 = buf[0]
    at = lambda i: int(buf[i] - t0) if buf[i] else None  # noqa: E731
    tiles = [j for j in range(64) if buf[128 + j]]
    return (f"end {at(1)}; per tile (producer past its wait, landed, done): "
            + " ".join(f"{j}:{at(64 + j)}/{at(128 + j)}/{at(192 + j)}" for j in tiles))


def registers(report):
    """The ptxas lines of registers and spills."""
    return [line.strip() for line in report.splitlines()
            if "registers" in line or "spill" in line]


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch import runtime
    from web_rwkv_gguf_tpu_torch.ops.cuda import build, matmul as mm, wkv4, wkv6, wkv7
    from web_rwkv_gguf_tpu_torch.runtime.engine import _bucket

    args = sys.argv[1:]
    match = ["wkv7_scan", "wkv6_scan"]
    if "--match" in args:
        i = args.index("--match")
        match = args[i + 1].split("|")
        del args[i:i + 2]
    variants = args or ["base"]
    if not torch.cuda.is_available():
        raise SystemExit("torch_scan_probe: needs a CUDA card")

    libs, jobs = {}, {}
    for kname, rep in build.build(KERNELS).items():
        for line in registers(rep):
            print(f"ptxas base {kname}: {line}", flush=True)
    for spec in dict.fromkeys(variants):
        if spec == "base":
            libs[spec] = {k: build.load(k) for k in KERNELS}
            continue
        src = variant_sources(build, re.sub(r"[^A-Za-z0-9]+", "_", spec), spec)
        for kname in KERNELS:
            out = src / f"lib{kname}.so"
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src / f"{kname}.cu")]
            jobs[(spec, kname)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), out)
    for (spec, kname), (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:  # reported; the other variants still run
            print(f"torch_scan_probe: {spec} {kname} failed to build:\n{log[-3000:]}", flush=True)
            variants = [v for v in variants if v != spec]
            continue
        for line in registers(log):
            print(f"ptxas {spec} {kname}: {line}", flush=True)
        libs.setdefault(spec, {})[kname] = ctypes.CDLL(str(out))

    hbm, bf16_peak, f32_peak = cs.peaks(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(cs.ENGINE_SEED)
    [rng.integers(0, cs.VOCAB, n) for n in cs.ENGINE_LENGTHS]  # chip_smoke's draws, in order
    _, _, full_rows = cs.full_input(runtime, _bucket, rng, cs.VOCAB)
    kmods = {"matmul": mm, "wkv7": wkv7, "wkv6": wkv6, "wkv4": wkv4}
    cases = {}
    for tag in ("v7", "v6", "v5"):
        for case in cs.MODEL_CASES[tag](torch, kmods, bf16_peak, f32_peak, full_rows):
            if any(s in case["name"] for s in match) and "_scan[" in case["name"]:
                cases.setdefault(case["name"], case)
    print(f"{torch.cuda.get_device_name(0)}; {cs.nvidia_smi()}", flush=True)
    # the wrappers bind through these (functools.cache'd) lookups
    binders = {"wkv6_scan": (wkv6, "_fn", build.load("wkv6_scan").wkv6_scan),
               "wkv7_scan": (wkv7, "_scan_fn", build.load("wkv7_scan").wkv7_scan)}
    for kname, (mod, attr, base_fn) in binders.items():
        getattr(mod, attr)()  # sets the committed entry's argtypes
    results = []
    for spec in variants:
        for kname, (mod, attr, base_fn) in binders.items():
            fn = getattr(libs[spec][kname], kname)
            fn.argtypes, fn.restype = base_fn.argtypes, base_fn.restype
            setattr(mod, attr, lambda fn=fn: fn)
        for name, case in cases.items():
            if "trace" in spec:
                print(f"{spec}: {name}: {trace(torch, case, libs[spec][name.split('[')[0]])}",
                      flush=True)
                continue
            if "off=" in spec:
                sets = [case["make_args"](i) for i in
                        range(max(2, -(-int(cs.L2_FLUSH_BYTES) // case["nbytes"])))]
                fields = {"ms": cs.time_graph(torch, [lambda a=a: case["kernel"](*a) for a in sets]),
                          "bound_ms": case["nbytes"] / hbm * 1e3, "max_abs_err": float("nan")}
                del sets
            else:
                try:
                    fields = cs.run_kernel_case(torch, case, hbm)
                except (AssertionError, RuntimeError) as e:  # the other cases still run
                    fields = {"failed": str(e)}
            r = {"variant": spec, "name": name, **fields}
            results.append(r)
            torch.cuda.empty_cache()
            if "failed" in r:
                print(f"{spec}: {name}: FAILED: {r['failed']}", flush=True)
            else:
                print(f"{spec}: {name}: {r['ms'] * 1e3:.4f} us, bound "
                      f"{r['bound_ms'] * 1e3:.4f} us, max_abs_err {r['max_abs_err']:.3e}",
                      flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
