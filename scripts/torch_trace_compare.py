#!/usr/bin/env python3
"""Trace of chip_smoke.py's card-vs-CPU decode check on one compare model.

For each ``tag:seed`` given (default ``v7q5:41 v7q5:42``) it builds the
two-layer comparison file of ``chip_smoke.MODELS[tag]`` at that seed and
runs chip_smoke's three decode steps (B=3, lane 2 frozen on the second),
through the per-layer kernels and through the whole-stack kernel, four
ways:

- on the card with the kernels, every kernel call also held against its
  plain version on the same inputs on the card (each call's
  max|kernel - plain| as a share of its chip_smoke tolerance; the worst
  per kernel is printed): a wrong product on this model's own
  activations shows here;
- on the card with every kernel wrapper replaced by its plain version
  (PyTorch ops on the card: another summation order than the CPU, no
  kernel of the port);
- on the CPU (the plain versions), as chip_smoke runs it;
- each step again from the CPU's own state before it, on the card and
  on the CPU: how much of a step's difference is made in that step and
  how much it carries from the steps before.

It prints max|a - b| / max|b| per chunk as chip_smoke does (logits,
shifts, each layer's WKV state). ``--hooks NAME`` runs every forward and
head with an example's hooks (``chip_smoke.HOOK_EXAMPLES``), and
``--prefill`` puts chip_smoke's first prefill chunk (T=37, lengths 37,
20, 0) before the decode steps, as its surface phase holds them. Needs
one CUDA card; from the repo root:

    python3 scripts/torch_trace_compare.py [--hooks NAME] [--prefill] [tag:seed ...]
"""

import contextlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from web_rwkv_gguf_tpu_torch import models  # noqa: E402
from web_rwkv_gguf_tpu_torch.gguf import GgufFile  # noqa: E402
from web_rwkv_gguf_tpu_torch.ops.cuda import layer7, layer56, matmul, wkv4, wkv6, wkv7  # noqa: E402

# every kernel wrapper, its plain version, and how a call is compared: each
# output over 1e-4·max|plain| ("rel": GEMV_TOL and GEMM_TOL, the matmuls;
# "att": the attention core's y on the live lanes and its state, as a share
# of WKV_TOL·max, since its states on a model's own activations are far
# larger than chip_smoke's absolute ATT_TOL assumes; "scan": WKV_TOL), or,
# for the whole-stack kernels ("stack"), layer by layer as chip_smoke holds
# them: each layer a one-layer launch on the plain chain's input, each
# array (the live lanes' x) over MEGA_LAYER_TOL·max|plain|
WRAPPERS = {
    "q4k_gemv": (matmul.q4k_gemv, matmul.q4k_gemv_plain, "rel"),
    "q4k_gemm": (matmul.q4k_gemm, matmul.q4k_gemm_plain, "rel"),
    "q6k_gemv": (matmul.q6k_gemv, matmul.q6k_gemv_plain, "rel"),
    "q6k_gemm": (matmul.q6k_gemm, matmul.q6k_gemm_plain, "rel"),
    "qkb_gemv": (matmul.qkb_gemv, matmul.qkb_gemv_plain, "rel"),
    "qkb_gemm": (matmul.qkb_gemm, matmul.qkb_gemm_plain, "rel"),
    "qs_gemv": (matmul.qs_gemv, matmul.qs_gemv_plain, "rel"),
    "qs_gemm": (matmul.qs_gemm, matmul.qs_gemm_plain, "rel"),
    "att_core7_step": (wkv7.att_core7_step, wkv7.att_core7_plain, "att"),
    "wkv7_scan": (wkv7.wkv7_scan, wkv7.wkv7_scan_plain, "scan"),
    "wkv6_scan": (wkv6.wkv6_scan, wkv6.wkv6_scan_plain, "scan"),
    "wkv4_scan": (wkv4.wkv4_scan, wkv4.wkv4_scan_plain, "scan"),
    "layer_scan7": (layer7.layer_scan7, layer7.layer_scan7_plain, "stack"),
    "layer_scan56": (layer56.layer_scan56, layer56.layer_scan56_plain, "stack"),
}


def rel_share(pairs, tol):
    return max((a - b).abs().max().item() / (tol * max(b.abs().max().item(), 1e-30))
               for a, b in pairs)


def stack_share(kernel, plain, args):
    """The worst array of any layer of a whole-stack call, each layer a
    one-layer launch of the kernel and of the plain version on the plain
    chain's input, as a share of MEGA_LAYER_TOL."""
    mega, state, x, mask, rescale, *eps = args
    v7 = "lora_dims" in mega
    live = mask > 0
    worst, x_l, v_first = 0.0, x, None
    for i in range(mega["L"]):
        m_i = layer7.mega_layers(mega, i, i + 1)
        s_i = {k: v[i:i + 1] for k, v in state.items()}
        tail = ((v_first, i),) if v7 else (i,)
        got = kernel(m_i, s_i, x_l, mask, rescale, *eps, *tail)
        want = plain(m_i, s_i, x_l, mask, rescale, *eps, *tail)
        pairs = [(got[0][live], want[0][live])] + [(got[1][k], want[1][k]) for k in want[1]]
        worst = max(worst, rel_share(pairs, cs.MEGA_LAYER_TOL))
        x_l, v_first = want[0], (want[2] if v7 else None)
    return worst


def share(how, kernel, plain, args, got, want):
    """A call's difference from its plain version as a share of its
    tolerance."""
    if how == "rel":
        return rel_share([(got, want)], cs.GEMV_TOL)
    if how == "scan":
        err, lim = cs.scan_compare(got, want)
        return err / lim
    if how == "att":
        live = args[12].bool()
        return rel_share([(got[0][live], want[0][live]), (got[1], want[1])], cs.WKV_TOL)
    return stack_share(kernel, plain, args)


@contextlib.contextmanager
def swapped(mode, worst):
    """Every module of the port that holds a kernel wrapper sees, instead,
    the wrapper checked against its plain version ("checked": the worst
    share per kernel lands in ``worst``) or the plain version alone
    ("plain")."""
    subs = {}
    for name, (kernel, plain, how) in WRAPPERS.items():
        if mode == "plain":
            subs[id(kernel)] = plain
        else:
            def checked(*args, _k=kernel, _p=plain, _h=how, _n=name, **kw):
                got = _k(*args, **kw)
                want = _p(*args, **kw)
                worst[_n] = max(worst.get(_n, 0.0), share(_h, _k, _p, args, got, want))
                return got
            subs[id(kernel)] = checked
    saved = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("web_rwkv_gguf_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            # a wrapper's own module keeps it: the wrapper counts its
            # launches on itself, by its module-level name
            if callable(val) and id(val) in subs and val.__module__ != mod.__name__:
                saved.append((mod, attr, val))
                setattr(mod, attr, subs[id(val)])
    try:
        yield
    finally:
        for mod, attr, val in saved:
            setattr(mod, attr, val)


def run_from(info, params, state, chunks, device, hooks=None):
    """chip_smoke.run_chunks from ``state`` (host tensors) instead of a
    zero state."""
    st = {k: v.to(device) for k, v in state.items()}
    out = []
    for toks, lens in chunks:
        n = torch.as_tensor(lens, device=device)
        x, st = models.forward_chunk(info, params, st, torch.as_tensor(toks, device=device), n,
                                     hooks=hooks)
        live = (n > 0).nonzero()[:, 0]
        logits = models.logits_head(params, x[live, n[live] - 1], hooks=hooks)
        out.append({"logits": logits.cpu(), **{k: v.cpu() for k, v in st.items()}})
    return out


def fmt(rel):
    return ", ".join(f"{k} {v:.3e}" for k, v in rel.items())


def over(rel):
    return [k for k, v in rel.items() if not v <= cs.card_cpu_limit(k)]


def trace(tag, seed, hooks=None, prefill=False):
    raw, _ = cs.build_file(tag, cs.COMPARE_LAYERS, seed)
    info, p_card = models.load_model(GgufFile(raw), device="cuda")
    _, p_cpu = models.load_model(GgufFile(raw), device="cpu")
    decode = [(np.array(t)[:, None], np.array(n)) for t, n in cs.COMPARE_STEPS]
    if prefill:
        T, lens = cs.COMPARE_PREFILL[0]
        prng = np.random.default_rng(cs.COMPARE_SEED)
        decode = [(prng.integers(0, cs.VOCAB, (len(lens), T)), np.array(lens))] + decode
    batch = len(cs.COMPARE_STEPS[0][1])
    for label, a, b in (("per-layer kernels", p_card, p_cpu),
                        ("whole-stack kernel", models.prepare_decode(p_card, info, batch),
                         models.prepare_decode(p_cpu, info, batch))):
        print(f"{tag} seed {seed}, {label} (limits {cs.CARD_CPU_TOL}, later layers' WKV "
              f"{cs.CARD_CPU_WKV_TOL}):", flush=True)
        cpu = cs.run_chunks(torch, models, info, b, decode, "cpu", hooks)
        worst = {}
        with swapped("checked", worst):
            card = cs.run_chunks(torch, models, info, a, decode, "cuda", hooks)
        print("  every kernel call against its plain version on its own inputs, worst share "
              "of its tolerance: " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
        with swapped("plain", {}):
            card_plain = cs.run_chunks(torch, models, info, a, decode, "cuda", hooks)
        for name, x, y in (("card kernels vs CPU", card, cpu),
                           ("card plain versions vs CPU", card_plain, cpu),
                           ("card kernels vs card plain versions", card, card_plain)):
            for i, rel in enumerate(cs.rel_diff(x, y)):
                print(f"  {name}, chunk {i}: {fmt(rel)}; past the limits: {over(rel) or 'none'}")
        print(f"  largest WKV state difference, card kernels vs CPU, at (lane, head) per layer: "
              f"{cs.wkv_max_at(card, cpu)}")
        for i in range(1, len(decode)):
            start = {k: v for k, v in cpu[i - 1].items() if k != "logits"}
            one_card = run_from(info, a, start, decode[i:i + 1], "cuda", hooks)
            one_cpu = run_from(info, b, start, decode[i:i + 1], "cpu", hooks)
            rel = cs.rel_diff(one_card, one_cpu)[0]
            print(f"  chunk {i} alone from the CPU's state before it, card kernels vs CPU: "
                  f"{fmt(rel)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_trace_compare: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    hooks = None
    if "--hooks" in args:
        i = args.index("--hooks")
        hooks = cs.HOOK_EXAMPLES[args[i + 1]](cs.COMPARE_LAYERS)
        del args[i:i + 2]
    prefill = "--prefill" in args
    for item in [a for a in args if a != "--prefill"] or ("v7q5:41", "v7q5:42"):
        tag, seed = item.split(":")
        trace(tag, int(seed), hooks, prefill)
    return 0


if __name__ == "__main__":
    sys.exit(main())
