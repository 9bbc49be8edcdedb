#!/usr/bin/env python3
"""Trace of one lane of chip_smoke.py's whole-stack check for an RWKV-7
model at B=1.

chip_smoke holds ``layer_scan7`` layer by layer, each layer a one-layer
launch on the plain version's chain, on the Engine's lanes as its timing
phases leave them (the prompts prefilled; the token each lane generated
last). This script rebuilds that state for ``chip_smoke.MODELS[tag]``
(default ``v7q5``), runs one of its lanes alone (B=1; lane 0, or the
one ``--lane`` names) down the plain chain — or with ``--batch B`` all
four lanes repeated to B lanes, all live, as chip_smoke holds the stack
at B ≠ 4, reporting the lane ``--lane`` names — and at
every layer prints, as shares of MEGA_LAYER_TOL (one bf16 step of each
array's max): the kernel against the plain version, and the plain
version with every quantized product moved by one f32 ulp (noise seeds 0
to 3, as chip_smoke's ``sensitivity()``) against the plain version, and
the plain version on the CPU (the same function, every sum in the CPU's
order: the LoRA products and the attention core's too) against it on the
card: how far the order of f32 sums alone moves that layer at that
input. Then it finds which of the layer's sums does so: the plain
version on the card again with one kind of its operations at a time run
on the CPU instead (the inner-LoRA pairs, the attention core, the layer
norms, the quantized products), each against the plain version on the
CPU; the kind whose move closes the gap holds the sensitive sum. Needs
one CUDA card; from the repo root:

    python3 scripts/torch_trace_lane.py [tag] [--lane N] [--batch B] [--gemm-source FILE]

``--gemm-source`` builds the dequant-GEMM entry points (``q4k_gemm``,
``q6k_gemm``, ``qkb_gemm``, ``qs_gemm``) from another ``qk_gemm.cu`` (an
earlier commit's, say) and makes the port launch them, so that the
Engine's prefill, and with it the lane's state, is the one that version
made.
"""

import ctypes
import math
import os
import subprocess
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from web_rwkv_gguf_tpu_torch import models, runtime  # noqa: E402
from web_rwkv_gguf_tpu_torch.gguf import GgufFile  # noqa: E402
from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS  # noqa: E402
from web_rwkv_gguf_tpu_torch.ops import basic  # noqa: E402
from web_rwkv_gguf_tpu_torch.ops.cuda import build, layer7, matmul  # noqa: E402

NOISE_SEEDS = (0, 1, 2, 3)


def shares(got, want, row=None):
    """Per array of a one-layer result (x, the state, v_first), max|got -
    want| (over lane ``row`` alone where given) over
    MEGA_LAYER_TOL·max|want| (over every lane, as chip_smoke holds it); the
    largest and its array."""
    a = {"x": got[0], "v_first": got[2], **got[1]}
    b = {"x": want[0], "v_first": want[2], **want[1]}

    def lane(k, t):
        if row is None:
            return t
        return t[:, row] if k in got[1] else t[row]

    s = {k: (lane(k, a[k]) - lane(k, b[k])).abs().max().item()
         / (cs.MEGA_LAYER_TOL * max(b[k].abs().max().item(), 1e-30)) for k in b}
    k = max(s, key=s.get)
    return f"{s[k]:.3f} ({k})"


def to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_dev(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def to_cpu(tree):
    return to_dev(tree, "cpu")


def on_cpu(fn):
    """``fn`` evaluated on the CPU, its result moved back to the card."""
    def wrapped(*args, **kw):
        return to_dev(fn(*to_cpu(args), **to_cpu(kw)), "cuda")
    return wrapped


# the kinds of operation in layer7.layer_scan7_plain, by the module names
# they are looked up under, and their stand-ins evaluated on the CPU
PIECES = {
    "LoRA pairs": {"lora_plain": on_cpu(layer7.lora_plain)},
    "attention core": {"att_core7_plain": on_cpu(layer7.att_core7_plain)},
    "layer norms": {"B_": types.SimpleNamespace(layer_norm=on_cpu(basic.layer_norm),
                                                squared_relu=basic.squared_relu)},
    "quantized products": {"slot_gemv_plain": on_cpu(layer7.slot_gemv_plain)},
}


def with_piece_on_cpu(piece, fn, *args):
    saved = {name: getattr(layer7, name) for name in PIECES[piece]}
    for name, sub in PIECES[piece].items():
        setattr(layer7, name, sub)
    try:
        return fn(*args)
    finally:
        for name, val in saved.items():
            setattr(layer7, name, val)


def use_gemm_source(path):
    """Build the dequant-GEMM library from ``path`` and have the port's
    GEMM wrappers launch its entry points."""
    out = build.BUILD_DIR / "qk_gemm-traced.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out),
                    path], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    real = build.load
    build.load = lambda name: lib if name == "qk_gemm" else real(name)
    for fn in (matmul._gemm_fn, matmul._qkb_fn, matmul._qs_fn, matmul._nf4_fn):
        fn.cache_clear()


def noisy_slot(seed):
    """layer7.slot_gemv_plain with each product element moved one f32 ulp up
    or down (probability 1/4 each), from a generator seeded with seed."""
    real = layer7.slot_gemv_plain
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def slot(desc, ops, i, x):
        y = real(desc, ops, i, x)
        u = torch.rand(y.shape, generator=gen, device=y.device)
        inf = torch.full_like(y, math.inf)
        return torch.where(u < 0.25, torch.nextafter(y, inf),
                           torch.where(u < 0.5, torch.nextafter(y, -inf), y))
    return slot


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_trace_lane: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    if "--gemm-source" in args:
        at = args.index("--gemm-source")
        build.build()
        use_gemm_source(args[at + 1])
        print(f"dequant-GEMM built from {args[at + 1]}", flush=True)
        del args[at:at + 2]
    opts = {"--lane": 0, "--batch": 1}
    for opt in opts:
        if opt in args:
            at = args.index(opt)
            opts[opt] = int(args[at + 1])
            del args[at:at + 2]
    lane, batch = opts["--lane"], opts["--batch"]
    tag = args[0] if args else "v7q5"
    spec = cs.MODELS[tag]
    build.build()
    raw, _ = cs.build_file(tag, spec["widths"]["n_layer"], spec["seed"])
    info, params = models.load_model(GgufFile(raw), device="cuda")
    rng = np.random.default_rng(cs.ENGINE_SEED)
    prompts = [[int(t) for t in rng.integers(0, cs.VOCAB, n)] for n in cs.ENGINE_LENGTHS]
    eng = runtime.Engine(info, params, num_batch=len(prompts), token_chunk_size=cs.ENGINE_CHUNK,
                         device="cuda")
    out = eng.generate(prompts, cs.ENGINE_TOKENS)
    eng.reset_state()
    eng.generate(prompts, 1)  # the state chip_smoke's check starts from
    mega = eng.params["mega7"]
    lanes = [lane] if batch == 1 else [b % len(prompts) for b in range(batch)]
    row = None if batch == 1 else lane
    x = models.embed_tokens(params, torch.tensor([[out[b][-1]] for b in lanes],
                                                 device="cuda"))[:, 0]
    state = {k: v[:, lanes].contiguous() for k, v in eng.state.items()}
    mask = torch.ones(batch, device="cuda")
    eps = (LN_EPS, GN_EPS, L2_EPS)
    real = layer7.slot_gemv_plain
    x_l, v_first = x, None
    for i in range(mega["L"]):
        m_i = layer7.mega_layers(mega, i, i + 1)
        s_i = {k: v[i:i + 1] for k, v in state.items()}
        args = (m_i, s_i, x_l, mask, None, *eps, (v_first, i))
        want = layer7.layer_scan7_plain(*args)
        got = layer7.layer_scan7(*args)
        noisy = []
        for seed in NOISE_SEEDS:
            layer7.slot_gemv_plain = noisy_slot(seed)
            try:
                noisy.append(shares(layer7.layer_scan7_plain(*args), want, row))
            finally:
                layer7.slot_gemv_plain = real
        cpu = layer7.layer_scan7_plain(*to_cpu(args))
        print(f"{tag} lane {lane} at B={batch}, layer {i}, share of MEGA_LAYER_TOL: kernel "
              f"against plain {shares(got, want, row)}; plain on the CPU against plain on the "
              f"card {shares(to_cpu(cpu), to_cpu(want), row)}; kernel against plain on the CPU "
              f"{shares(to_cpu(got), cpu, row)}; plain with one-ulp product changes "
              f"against plain, seeds {NOISE_SEEDS}: {', '.join(noisy)}", flush=True)
        moved = []
        for piece in PIECES:
            moved_plain = with_piece_on_cpu(piece, layer7.layer_scan7_plain, *args)
            moved.append(f"{piece} {shares(to_cpu(moved_plain), cpu, row)}")
        print(f"  plain on the card with one kind of operation on the CPU, against plain on "
              f"the CPU: {'; '.join(moved)}", flush=True)
        x_l, v_first = want[0], want[2]
    return 0


if __name__ == "__main__":
    sys.exit(main())
