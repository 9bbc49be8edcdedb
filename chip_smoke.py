#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``web_rwkv_gguf_tpu_torch/
ops/cuda/csrc`` with nvcc, holds each kernel against its plain PyTorch
version at the shapes the decode path gives it and times both, then
serves two requests on a synthetic RWKV-7 0.1B-width Q4_K_M model
through the port's entry points (``load_model`` → ``forward_chunk`` →
``logits_head`` → ``make_generator``), checks the launch counts and the
outputs, and compares decode steps on the card with the CPU at the same
widths (two layers, three lanes, one of them frozen for a step). Any failed check raises, so the exit code is not 0.
The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON line of per-kernel numbers, and ``{"ok": true, "device": {...}}``.

With no CUDA card, or outside a checkout, it exits non-zero at once and
prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# model under test: RWKV-7 0.1B widths (L=12, C=768, head 64, V=65536,
# hidden 4·C, LoRA ranks w/a/g/v 64/64/128/32), Q4_K layers, Q6_K head
MODEL = dict(n_layer=12, n_emb=768, head_size=64, n_vocab=65536, n_hidden=3072,
             lora_w=64, lora_a=64, lora_g=128, lora_v=32)
PROMPTS = ([11, 2041, 7, 65000, 310, 42, 9, 1234], [5, 5, 60000, 88, 901, 3, 77, 12])
DECODE_STEPS = 32
COMPARE_LAYERS = 2  # depth of the card-vs-CPU comparison
# its decode steps at B=3: (token per lane, length per lane)
COMPARE_STEPS = [([11, 400, 65535], [1, 1, 1]), ([2041, 9, 3], [1, 1, 0]),
                 ([7, 60000, 5], [1, 1, 1])]
SEED = 0

# peaks of the card from NVIDIA's data sheets (dense): HBM bytes/s,
# bf16 tensor-core FLOP/s, f32 (non-tensor) FLOP/s
PEAKS = {
    "PCIe": (2.0e12, 756e12, 51e12),
    "NVL": (3.9e12, 835e12, 60e12),
    "SXM": (3.35e12, 989e12, 67e12),
}
GEMV_TOL = 1e-4  # × max|plain|: the same f32 terms summed in another order
ATT_TOL = 1e-4  # absolute, on y of the active lanes and on the state
# × max|CPU| per array, decode steps on the card vs the CPU at L=2. The
# kernels and cuBLAS sum in another order than the CPU, and the matmuls
# round their operands to bf16: a last-bit difference upstream can flip
# one operand's rounding by 2^-8, which moves this random-weight model's
# logits by up to 1.4e-3 of their max (seen on the CPU alone between a
# lane run at B=3 and the same lane at B=1). 1e-2 is ~2.5 bf16 steps.
CARD_CPU_TOL = 1e-2
L2_FLUSH_BYTES = 100e6  # rotate weight copies over 2× the 50 MB L2


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not measured"


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["SXM"]


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------


def time_graph(torch, calls, reps=3):
    """Device ms per call: ``calls`` (one per rotated weight copy) captured
    into one CUDA graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * len(calls))


def time_eager(torch, calls):
    """ms per call, issued eagerly from the host between CUDA events."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for c in calls:
        c()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(calls)


def run_kernel_case(torch, case, hbm):
    """Compare the kernel with its plain version on one set of inputs,
    then time both over rotated input copies; returns the JSON fields."""
    name, kernel, plain = case["name"], case["kernel"], case["plain"]
    args = case["make_args"](0)
    want = plain(*args)
    got = kernel(*args)
    torch.cuda.synchronize()
    err, limit = case["compare"](got, want)
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    copies = max(2, math.ceil(L2_FLUSH_BYTES / case["nbytes"]))
    sets = [args] + [case["make_args"](i) for i in range(1, copies)]
    ms = time_graph(torch, [lambda a=a: kernel(*a) for a in sets])
    eager_ms = time_eager(torch, [lambda a=a: kernel(*a) for a in sets])
    plain_ms = time_eager(torch, [lambda a=a: plain(*a) for a in sets[:8]])
    bytes_ms = case["nbytes"] / hbm * 1e3
    ops_ms = case["flops"] / case["fpeak"] * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    bound_ms = max(bytes_ms, ops_ms)
    log(f"  {name}: {case['nbytes'] / 1e6:.4f} MB, bound {bound_ms * 1e3:.4f} us "
        f"({bound_by}), kernel {ms * 1e3:.4f} us in a graph, {eager_ms * 1e3:.4f} us "
        f"issued eagerly, plain {plain_ms * 1e3:.4f} us, {copies} input copies")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def kernel_cases(torch, mm, core, bf16_peak, f32_peak, dev="cuda"):
    """The decode path's kernel calls at its shapes: Q4_K gemv at the layer
    shapes (n = 1 and 8), the Q6_K head gemv (n = 1), and the attention
    core at B=1 and at B=3 with a masked lane (H=12, hs=64)."""
    dev = torch.device(dev)

    def rng(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        ints = lambda lo, hi, s, dt: torch.randint(  # noqa: E731
            lo, hi, s, generator=g, device=dev, dtype=dt)
        floats = lambda *s: torch.rand(*s, generator=g, device=dev)  # noqa: E731
        normal = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
        return ints, floats, normal

    def gemv_compare(got, want):
        return (got - want).abs().max().item(), GEMV_TOL * want.abs().max().item()

    cases = []
    for m, k in ((768, 768), (3072, 768), (768, 3072)):
        for n in (1, 8):
            def make(i, m=m, k=k, n=n):
                ints, floats, normal = rng(1000 * i + m + 7 * k + n)
                return (normal(n, k).to(torch.bfloat16),
                        ints(0, 256, (m, k // 2), torch.uint8),
                        ints(0, 64, (m, k // 32), torch.uint8),
                        ints(0, 64, (m, k // 32), torch.uint8),
                        floats(m, k // 256) * 1e-2, floats(m, k // 256) * 1e-2)
            cases.append(dict(
                name=f"q4k_gemv[m={m},k={k},n={n}]", kernel=mm.q4k_gemv, shape=(n, m, k),
                plain=mm.q4k_gemv_plain, make_args=make, compare=gemv_compare,
                nbytes=m * k // 2 + 2 * m * k // 32 + 8 * m * k // 256 + 2 * n * k + 4 * n * m,
                flops=2 * n * m * k, fpeak=bf16_peak))
    m, k, n = 65536, 768, 1

    def make_head(i):
        ints, floats, normal = rng(2000 * i + 1)
        return (normal(n, k).to(torch.bfloat16), ints(-32, 32, (m, k), torch.int8),
                ints(-128, 128, (m, k // 16), torch.int8), floats(m, k // 256) * 1e-3)
    cases.append(dict(
        name=f"q6k_gemv[m={m},k={k},n={n}]", kernel=mm.q6k_gemv, shape=(n, m, k),
        plain=mm.q6k_gemv_plain, make_args=make_head, compare=gemv_compare,
        nbytes=m * k + m * k // 16 + 4 * m * k // 256 + 2 * n * k + 4 * n * m,
        flops=2 * n * m * k, fpeak=bf16_peak))

    H, K = 12, 64
    for B in (1, 3):
        active = [0] if B == 1 else [0, 2]  # lanes the mask keeps running

        def make_att(i, B=B):
            _, _, normal = rng(3000 * i + B)
            f = lambda *s: normal(*s) * 0.5  # noqa: E731
            mask = torch.tensor([True, False, True][:B], device=dev)
            return (f(B, H, K, K), f(B, H, K), f(B, H, K), f(B, H, K), f(B, H, K),
                    f(B, H, K), torch.sigmoid(f(B, H, K)), f(H, K), f(H, K),
                    1 + 0.1 * f(H, K), 0.1 * f(H, K), f(H, K), mask, 64e-5, 1e-12)

        def att_compare(got, want, active=active):
            (y1, s1), (y0, s0) = got, want  # masked lanes' y is unspecified
            err = max((s1 - s0).abs().max().item(),
                      (y1[active] - y0[active]).abs().max().item())
            return err, ATT_TOL

        cases.append(dict(
            name=f"att_core7[B={B},H={H},hs={K}]", kernel=core.att_core7_step,
            shape=(B, H, K),
            plain=core.att_core7_plain, make_args=make_att, compare=att_compare,
            # state in and out; r, w, k, a, v, g in and y out; 5 params; mask
            nbytes=4 * (2 * B * H * K * K + 7 * B * H * K + 5 * H * K + B),
            flops=8 * B * H * K * K, fpeak=f32_peak))
    return cases


# --------------------------------------------------------------------------
# model phases
# --------------------------------------------------------------------------


def serve(torch, models, info, params, prompts, steps):
    """Answer each prompt at batch 1: the prompt fed one token at a time
    through forward_chunk, its last logits through logits_head and a
    greedy pick, then ``steps`` greedy tokens from make_generator.
    Returns the tokens per request and the seconds of prompt feeding and
    of generation."""
    dev = params["emb"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = models.make_generator(info, steps=steps)
    out, t_prompt, t_gen = [], 0.0, 0.0
    one = torch.ones(1, dtype=torch.long, device=dev)
    for prompt in prompts:
        sync()
        t0 = time.perf_counter()
        state = models.init_state(info, 1, device=dev)
        for tok in prompt:
            x, state = models.forward_chunk(info, params, state,
                                            torch.tensor([[tok]], device=dev), one)
        logits = models.logits_head(params, x[:, 0])
        first = torch.argmax(logits, dim=-1)
        sync()
        t1 = time.perf_counter()
        toks, last, state, _, _ = gen(params, state, first[:, None])
        sync()
        t2 = time.perf_counter()
        if not (torch.isfinite(logits).all() and torch.isfinite(last).all()
                and all(torch.isfinite(v).all() for v in state.values())):
            raise AssertionError("non-finite logits or state")
        if tuple(logits.shape) != (1, info.num_vocab) or tuple(toks.shape) != (1, steps):
            raise AssertionError(f"unexpected shapes {logits.shape} {toks.shape}")
        out.append([int(first)] + toks[0].tolist())
        t_prompt += t1 - t0
        t_gen += t2 - t1
    return out, t_prompt, t_gen


def profile_decode(torch, models, info, params, steps=8):
    """Device kernel time per decoded token, in all and by kernel, from
    torch.profiler over ``steps`` generator steps (device-side kernel
    events only, so no time is counted twice); None where the profiler
    saw no device time. Also the wall µs per token under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    dev = params["emb"].device
    gen = models.make_generator(info, steps=steps)
    state = models.init_state(info, 1, device=dev)
    tok = torch.tensor([[1]], device=dev)
    gen(params, state, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen(params, state, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue  # host-side op: its kernels are listed on their own
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / steps, ev.key, ev.count / steps))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return (total if total > 0 else None), wall / steps * 1e6, rows


def compare_card_cpu(torch, models, GgufFile, raw, steps, card="cuda"):
    """Decode steps on the card and on the CPU from the same file, at the
    batch the steps give; ``steps`` is a list of (tokens [B], lengths [B]).
    Returns the largest |card - cpu| / max|cpu| over the logits and each
    state array."""
    info, p_gpu = models.load_model(GgufFile(raw), device=card)
    _, p_cpu = models.load_model(GgufFile(raw), device="cpu")
    batch = len(steps[0][0])
    st_g = models.init_state(info, batch, device=card)
    st_c = models.init_state(info, batch, device="cpu")
    worst = {}
    for toks, lens in steps:
        t, n = torch.tensor(toks)[:, None], torch.tensor(lens)
        x_g, st_g = models.forward_chunk(info, p_gpu, st_g, t.to(card), n.to(card))
        x_c, st_c = models.forward_chunk(info, p_cpu, st_c, t, n)
        live = n > 0  # a zero-length lane's x is unspecified; its state is kept
        pairs = {"logits": (models.logits_head(p_gpu, x_g[:, 0])[live.to(card)],
                            models.logits_head(p_cpu, x_c[:, 0])[live])}
        pairs.update({k: (st_g[k], st_c[k]) for k in st_c})
        for key, (g, c) in pairs.items():
            rel = (g.cpu() - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
            worst[key] = max(worst.get(key, 0.0), rel)
    return worst


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this run needs one", file=sys.stderr)
        return 1
    try:
        from web_rwkv_gguf_tpu_torch import models
        from web_rwkv_gguf_tpu_torch.gguf import GgufFile
        from web_rwkv_gguf_tpu_torch.ops.cuda import build
        from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm
        from web_rwkv_gguf_tpu_torch.ops.cuda import wkv7 as core
        from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
        from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repo ({e})",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    hbm, bf16_peak, f32_peak = peaks(kind)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"peaks used for bounds: {hbm / 1e12} TB/s HBM, {bf16_peak / 1e12} TFLOP/s bf16, "
        f"{f32_peak / 1e12} TFLOP/s f32")

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- kernels against their plain versions -------------------------------
    log("kernels (each against its plain PyTorch version, same inputs):")
    entries, cases = [], kernel_cases(torch, mm, core, bf16_peak, f32_peak)
    sources = {"q4k_gemv": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/q4k_gemv.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:793"),
               "q6k_gemv": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/q6k_gemv.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:629"),
               "att_core7": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/att_core7.cu",
                             "web_rwkv_gguf_tpu/ops/pallas/wkv7.py:108")}
    for case in cases:
        fields = run_kernel_case(torch, case, hbm)
        kname = case["name"].split("[")[0]
        entries.append({"name": case["name"], "route": "cuda",
                        "source": sources[kname][0], "replaces": sources[kname][1],
                        "launches": None, **fields})

    # ---- the main path: two requests on the 0.1B-width Q4_K_M model ---------
    t0 = time.perf_counter()
    raw = make_v7_gguf(**MODEL, seed=SEED, quantize=GgmlDType.Q4_K,
                       head_quantize=GgmlDType.Q6_K)
    log(f"model file: {len(raw) / 1e6:.1f} MB written in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    info, params = models.load_model(GgufFile(raw), device="cuda")
    torch.cuda.synchronize()
    log(f"load_model on cuda: {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e6:.1f} MB on the card")
    if params["head"].kind != "qk_nomin" or params["blocks"]["att"]["Wk"].kind != "qk":
        raise AssertionError("the model did not load in the Q4_K_M placement")

    counters = (mm.q4k_gemv, mm.q6k_gemv, core.att_core7_step)
    for fn in counters:
        fn.launches = 0
        fn.shapes.clear()
    tokens1, t_prompt, t_gen = serve(torch, models, info, params, PROMPTS, DECODE_STEPS)
    launches = {fn.__name__: fn.launches for fn in counters}
    L, n_req = info.num_layer, len(PROMPTS)
    steps = sum(len(p) for p in PROMPTS) + n_req * DECODE_STEPS  # forward_chunk calls
    want = {"q4k_gemv": 6 * L * steps, "att_core7_step": L * steps,
            "q6k_gemv": n_req * (1 + DECODE_STEPS)}
    log(f"main path launches: {launches} (expected {want}; per decoded token "
        f"{6 * L} Q4_K, {L} att-core, 1 Q6_K)")
    if launches != want:
        raise AssertionError("the main path did not run through every kernel as expected")
    log(f"main path launches by shape: "
        + "; ".join(f"{fn.__name__} {dict(fn.shapes)}" for fn in counters))
    # "launches": the kernel's count over the main path; "launches_at_shape":
    # those at this entry's shape (0 for a batched shape the B=1 path skips)
    for entry, case in zip(entries, cases):
        fn = case["kernel"]
        entry["launches"] = fn.launches
        entry["launches_at_shape"] = fn.shapes[case["shape"]]

    tokens2, t_prompt2, t_gen2 = serve(torch, models, info, params, PROMPTS, DECODE_STEPS)
    if tokens1 != tokens2:
        raise AssertionError("greedy tokens differ between two runs")
    if not all(0 <= t < info.num_vocab for req in tokens1 for t in req):
        raise AssertionError("token out of range")
    n_dec = n_req * DECODE_STEPS
    log(f"requests: {n_req} x ({len(PROMPTS[0])} prompt tokens at T=1 + 1 + {DECODE_STEPS} "
        f"greedy); tokens identical across two runs; first request {tokens1[0][:8]}...")
    log(f"eager decode at B=1: {n_dec / t_gen2:.2f} tok/s ({t_gen2 / n_dec * 1e3:.3f} ms/token; "
        f"first run {n_dec / t_gen:.2f} tok/s), prompt feed {t_prompt2 / (n_req * 8) * 1e3:.3f} "
        f"ms/token, on {smi}")

    busy, prof_wall_us, rows = profile_decode(torch, models, info, params)
    if busy is None:
        log("profile: no device time recorded (not measured)")
    else:
        wall_us = t_gen2 / n_dec * 1e6
        log(f"profile (8 decode steps): device kernel time {busy:.1f} us/token, "
            f"{sum(r[2] for r in rows):.0f} kernels/token; busy share "
            f"{busy / wall_us:.3f} of the unprofiled {wall_us:.1f} us/token "
            f"({prof_wall_us:.1f} us/token under the profiler)")
        for us, key, count in rows[:15]:
            log(f"  {us:9.2f} us/token  x{count:<6.1f} {key[:90]}")

    # ---- the card against the CPU, same widths, two layers -------------------
    t0 = time.perf_counter()
    raw2 = make_v7_gguf(**{**MODEL, "n_layer": COMPARE_LAYERS}, seed=SEED + 1,
                        quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K)
    worst = compare_card_cpu(torch, models, GgufFile, raw2, COMPARE_STEPS)
    log(f"card vs CPU, L={COMPARE_LAYERS}, B=3, {len(COMPARE_STEPS)} decode steps "
        "(lane 2 frozen on the second): max |card-cpu|/max|cpu| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (tolerance {CARD_CPU_TOL}); {time.perf_counter() - t0:.1f} s")
    if not all(v <= CARD_CPU_TOL for v in worst.values()):
        raise AssertionError("the card disagrees with the CPU")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
