#!/usr/bin/env python3
"""Time variants of a whole-stack decode kernel (``csrc/layer7.cu``, row 4,
or with ``--kernel layer56`` ``csrc/layer56.cu``, row 13) against each
other on the card, in one process, with the device time of each phase.

A variant is the committed source with some of its parts switched off
(``off=work``: every phase's work, leaving the launch and its grid
barriers; see ``PARTS``), or with ``trace`` stamps put in (block 0's
device clock at points inside each phase of layer 1, into ``phase_ns``;
see ``TRACE_POINTS`` and ``TRACE56``); each is built from a copy of
``csrc/`` into ``ops/cuda/_build/probe/<variant>/`` (gitignored), all at
once, and bound in place of the kernel in turn. Every variant runs the
same stack cases of ``torch_kernel_cases.py`` (``--stacks``: its
``STACK_FORMS`` for layer7, the RWKV-7 0.1B widths at full depth; its
``STACKS56`` for layer56), each at each of ``--batches`` lanes, in the
order given, so one call's numbers compare on one card. From the repo
root:

    python3 scripts/torch_stack_probe.py [--kernel layer7|layer56] \\
        [--stacks Q4_K,Q6_K,BF16] [--batches 1,4,16] base off=work off=prefetch trace

``base`` is the committed source; it is held against the plain version
(layer by layer, as chip_smoke holds it) before it is timed, a variant
with parts off is only timed. Prints each variant's registers and spills
(``-Xptxas -v``), one line per case and variant (µs per launch in a CUDA
graph over rotated copies, and µs per layer by phase: the device clock
after each grid barrier, median of 5 launches; the phases' names are the
module's ``PHASES``), and last one JSON line of every result.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

# parts a variant can switch off, by kernel: [(source file, pattern,
# replacement), ...] each
PARTS = {"layer7": {
    # every phase's work: the layer loop keeps only its grid barriers
    "work": [("layer7.cu",
              r"if \(ph == 2\) phase_att\(a, p, l, smem\);\n\s*else mat_phase<NB>\([^;]*\);", ";")],
    # the attention phase
    "att": [("layer7.cu", r"if \(ph == 2\) phase_att\(a, p, l, smem\);", "if (ph == 2) {}")],
    # the weight copies issued ahead (the products read stale tiles)
    "prefetch": [("layer7.cu",
                  r"(const stk::Job& j = locate\(p, phase, blockIdx.x, tile, s, tbase\);\s*)"
                  r"stk::load_job_item\(j, l, tile, s, buf, bs, which\);",
                  r"\1(void)j; bs.arm(which); "
                  r"if (threadIdx.x == 32) stk::mbar_expect_tx(bs.bar + which, 0);")],
    # the factor table of each matrix item
    "table": [("layer7.cu", r"stk::factor_table\(j, s, buf, tab\);", ";")],
    # the tensor-core products of the matrix phases
    "mma": [("stack_phase.cuh", r"  if constexpr \(kByMode\) warp_tile_by_mode<NB>\(j, buf, tab, xs, xsum, acc\);\n"
             r"  else warp_tile<NB>\(j, buf, tab, xs, xsum, acc\);",
             "  for (auto& f : acc) for (float& e : f) e = 0.f;")],
    # the small-B row path (Wo and the FFN value as tiles at every B)
    "rows": [("layer7.cu", r"return \(phase == 3 \|\| phase == 5\) && NB <= 2;", "return false;")],
    # the wait for an item's weight copies (timing only)
    "wait": [("layer7.cu", r"      bs.wait\(which\);\n", "      ;\n")],
    # the register cap of two blocks an SM (255 registers, one block an SM)
    "twoblocks": [("layer7.cu", r"__launch_bounds__\(kThreads, 2\)",
                   "__launch_bounds__(kThreads, 1)")],
    # the proxy fences before bulk copies (timing only: unordered copies)
    "fence": [("stack_mma.cuh", r"  if \(global\) asm volatile[^\n]*\n  else asm volatile[^\n]*\n",
               "  (void)global;\n")],
}, "layer56": {
    # every phase's work (and the ring's first copies): only the grid barriers
    "work": [("layer56.cu", r"switch \(p.kind\[ph\]\) \{.*?\n      \}\n", "\n", re.S),
             ("layer56.cu", r"for \(int i = 0; i < p.ring; \+\+i\) rg.issue\(p, a.L, smem\);", ";")],
    # the attention phase (versions 6 and 5)
    "att": [("layer56.cu", r"if constexpr \(V != 4\) phase_att<V>\(a, l, work\);", ";")],
    # version 6's mixes
    "mix": [("layer56.cu", r"if constexpr \(V == 6\) phase_mix<NB>\(a, l, work\);", ";")],
    # the tensor-core products of the matrix phases
    "mma": [("stack_phase.cuh", r"  if constexpr \(kByMode\) warp_tile_by_mode<NB>\(j, buf, tab, xs, xsum, acc\);\n"
             r"  else warp_tile<NB>\(j, buf, tab, xs, xsum, acc\);",
             "  for (auto& f : acc) for (float& e : f) e = 0.f;")],
    # the factor table of each matrix item
    "table": [("layer56.cu", r"stk::factor_table\(j, s, buf, tab\);", ";")],
    # each block's LayerNorm statistics
    "stats": [("layer56.cu", r"    ln_stats\(a.x, B, a.C, a.eps_ln, mean, rs, segs\);", "    ;")],
}}

# `trace` (layer7): block 0's device clock at points inside each phase of
# layer 1 (into phase_ns, whose own stamps are dropped): [phase][point],
# points 0 after the barrier (and the copies issued there), 1 the weights
# waited for, 2 a LayerNorm phase's inputs landed, 4 staged, 9 the block's
# work done (phase 2: 1 loads, 2 row terms, 3 state)
TRACE_POINTS = (
    (r"(#include \"stack_phase.cuh\"\n)",
     r"\1#define L7T(ph, k) do { if (a.phase_ns != nullptr && blockIdx.x == 0 && "
     r"threadIdx.x == 0 && l == 1) a.phase_ns[((ph) - 1) * 10 + (k)] = globaltimer_ns(); } "
     r"while (0)\n"),
    (r"    if \(stamp\) a.phase_ns\[n\] = globaltimer_ns\(\);\n", ""),
    (r"  if \(stamp\) a.phase_ns\[n\] = globaltimer_ns\(\);\n", ""),
    (r"(      if \(ph == 2\) phase_att\(a, p, l, smem\);\n      else mat_phase<NB>\([^;]*\);)",
     r"      L7T(ph, 0);\n\1\n      L7T(ph, 9);"),
    (r"(    bs.wait\(which\);[^\n]*\n)", r"\1    L7T(phase, 1);\n"),
    (r"(    \}\);\n)(    stk::item_products<NB>)", r"\1    L7T(phase, 4);\n\2"),
    (r"(    bs.wait\(2\);\n)", r"\1    L7T(j.input == kInMix2 ? 4 : 1, 2);\n"),
    (r"(    __syncthreads\(\);\n)(    float u\[4\] = )", r"\1    L7T(2, 1);\n\2"),
    (r"(    __syncthreads\(\);\n)(    // the state: sa)", r"\1    L7T(2, 2);\n\2"),
    (r"(    // the head's group norm)", r"    L7T(2, 3);\n\1"),
)

# `trace` (layer56): block 0's device clock in each phase ph of layer 1, at
# [ph][point]: 0 the phase's start, 1 + 3i, 2 + 3i, 3 + 3i its item i's
# weights waited for, input staged and products done (i < 3), 9 its end
TRACE56 = (
    (r"(#include \"stack_phase.cuh\"\n)",
     r"\1#define L56T(ph, k) do { if (a.phase_ns != nullptr && blockIdx.x == 0 && "
     r"threadIdx.x == 0 && l == 1) a.phase_ns[(ph) * 10 + (k)] = globaltimer_ns(); } "
     r"while (0)\n"),
    (r"  if \(stamp\) a.phase_ns\[n\] = globaltimer_ns\(\);\n", ""),  # both stamps
    (r"(      switch \(p.kind\[ph\]\) \{)", r"      L56T(ph, 0);\n\1"),
    (r"(\n      grid.sync\(\);)", r"\n      L56T(ph, 9);\1"),
    (r"(    const int b = rg.used\+\+ % p.ring;\n)",
     r"\1    const int it = (item - (int)blockIdx.x) / (int)gridDim.x;\n"),
    (r"(      rg.bs.wait\(b\);\n)", r"\1      if (it < 3) L56T(ph, 1 + 3 * it);\n"),
    (r"(\n    auto freed = \[&\]\(\))", r"\n    if (it < 3) L56T(ph, 2 + 3 * it);\1"),
    (r"(        resid \? a.x : nullptr, a.C, xold, freed, epi\);\n)",
     r"\1    if (it < 3) L56T(ph, 3 + 3 * it);\n"),
)


def variant_sources(build, kernel, name, spec):
    """A copy of csrc/ with the parts of ``off=a+b`` switched off, or
    ``trace`` stamps put in."""
    out = build.BUILD_DIR / "probe" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for item in spec.split(","):
        if item == "trace":
            edits = [(f"{kernel}.cu", pat, rep)
                     for pat, rep in (TRACE_POINTS if kernel == "layer7" else TRACE56)]
        else:
            key, value = item.split("=")
            if key != "off":
                raise SystemExit(f"torch_stack_probe: unknown variant item {item}")
            edits = [e for part in value.split("+") for e in PARTS[kernel][part]]
        for fname, pat, rep, *flags in edits:
            path = out / fname
            text, hits = re.subn(pat, rep, path.read_text(), flags=flags[0] if flags else 0)
            if not hits:
                raise SystemExit(f"torch_stack_probe: {item}: {pat!r} not found in {fname}")
            path.write_text(text)
    return out


def bind(lib, kernel):
    fn = getattr(lib, "layer_scan7" if kernel == "layer7" else "layer_scan56")
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def registers(report):
    return [line.strip() for line in report.splitlines() if "registers" in line or "spill" in line]


def trace_us(torch, case, n_phases, reps=5):
    """A trace build's stamps: per phase, (point, µs after phase 1's point
    0), the median of ``reps`` launches."""
    runs = []
    for _ in range(reps):
        ns = torch.zeros(1 + n_phases * case["L"], dtype=torch.int64, device="cuda")
        case["kernel"](*case["make_args"](0), phase_ns=ns)
        runs.append(ns[:n_phases * 10].view(n_phases, 10).double())
    t = torch.stack(runs).median(0).values
    return [[(k, (t[ph, k] - t[0, 0]).item() / 1e3) for k in range(10) if t[ph, k] > 0]
            for ph in range(n_phases)]


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, here)
    import torch

    import chip_smoke as cs
    import torch_kernel_cases as kc
    from web_rwkv_gguf_tpu_torch.ops.cuda import build, layer7, layer56

    args = sys.argv[1:]
    kernel = "layer7"
    if "--kernel" in args:
        i = args.index("--kernel")
        kernel = args[i + 1]
        del args[i:i + 2]
    if kernel not in PARTS:
        raise SystemExit(f"torch_stack_probe: --kernel is one of {list(PARTS)}")
    mod = layer7 if kernel == "layer7" else layer56
    opts = {"--stacks": "Q4_K,Q6_K,BF16" if kernel == "layer7" else "v6-Q4_K,v5-Q4_K,v4-Q4_K",
            "--batches": "1,4,16"}
    for key in opts:
        if key in args:
            i = args.index(key)
            opts[key] = args[i + 1]
            del args[i:i + 2]
    forms = opts["--stacks"].split(",")
    batches = [int(b) for b in opts["--batches"].split(",")]
    variants = args or ["base"]
    if not torch.cuda.is_available():
        raise SystemExit("torch_stack_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    stack_dir = os.path.abspath(os.path.join(str(build.BUILD_DIR), "stacks"))
    kc.build_stack_files(stack_dir, forms)

    libs, jobs = {}, {}
    for line in registers(build.build((kernel,)).get(kernel, "")):
        print(f"ptxas base: {line}", flush=True)
    for spec in dict.fromkeys(variants):
        if spec == "base":
            libs[spec] = bind(build.load(kernel), kernel)
            continue
        src = variant_sources(build, kernel, re.sub(r"[^A-Za-z0-9]+", "_", spec), spec)
        out = src / f"lib{kernel}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src / f"{kernel}.cu")]
        jobs[spec] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), out)
    for spec, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_stack_probe: {spec} failed to build:\n{log[-6000:]}")
        for line in registers(log):
            print(f"ptxas {spec}: {line}", flush=True)
        libs[spec] = bind(ctypes.CDLL(str(out)), kernel)

    hbm, bf16_peak, f32_peak = cs.peaks(torch.cuda.get_device_name(0))
    print(f"{torch.cuda.get_device_name(0)}; {cs.nvidia_smi()}", flush=True)
    cases = kc.stack_cases(torch, stack_dir, forms, batches, bf16_peak, f32_peak)
    results = []
    for spec in variants:
        mod._fn = lambda fn=libs[spec]: fn
        for case in cases:
            if spec == "base":
                try:
                    fields = cs.run_kernel_case(torch, case, hbm)
                except AssertionError as e:
                    fields = {"failed": str(e)}
            else:
                sets = [case["make_args"](i) for i in
                        range(max(2, -(-int(cs.L2_FLUSH_BYTES) // case["nbytes"])))]
                fields = {"ms": cs.time_graph(torch, [lambda a=a: case["kernel"](*a)
                                                      for a in sets]),
                          "bound_ms": case["nbytes"] / hbm * 1e3}
                del sets
            n_phases = len(case["phases"])
            if "trace" in spec:
                fields["trace_us"] = trace_us(torch, case, n_phases)
            elif "failed" not in fields:
                fields["phase_us"] = kc.phase_us(torch, case, n_phases)
                fields["phases"] = list(case["phases"])
            results.append({"variant": spec, "name": case["name"], **fields})
            torch.cuda.empty_cache()
    for r in results:
        if "failed" in r:
            print(f"{r['variant']}: {r['name']}: FAILED: {r['failed']}")
            continue
        if "trace_us" in r:
            print(f"{r['variant']}: {r['name']}: {r['ms'] * 1e3:.4f} us; layer 1, block 0, "
                  "µs from phase 1's start: " + "; ".join(
                      f"phase {ph + 1}: " + " ".join(f"{k}:{t:.2f}" for k, t in pts)
                      for ph, pts in enumerate(r["trace_us"])))
            continue
        print(f"{r['variant']}: {r['name']}: {r['ms'] * 1e3:.4f} us, bound "
              f"{r['bound_ms'] * 1e3:.4f} us; µs per layer by phase: " + ", ".join(
                  f"{n} {t:.2f}" for n, t in zip(r["phases"], r["phase_us"])))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
