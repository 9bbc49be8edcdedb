#!/usr/bin/env python3
"""Two probes of the dequant-GEMM (``csrc/qk_gemm.cu``) on the card.

- The offset term's share of the kernel's time: the same u8-code GEMM
  with f32 group offsets and without them (the kernel without offsets
  takes neither the group sums of x nor the f32 products), in a CUDA
  graph over rotated copies, at the prefill shapes n = 512.
- The drift of its sums on same-signed inputs: the inputs of
  ``tests/test_torch_cuda.py::test_gemm_on_same_signed_inputs_on_card``
  (relu² rows, K = 3072) at n = 64 and 512, the kernel against its plain
  version as a share of the test's limit, 1e-4·max|y|.

From the repo root, on a machine with one card:

    python3 scripts/torch_gemm_probe.py
"""

import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
import test_torch_cuda as cards  # noqa: E402
from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm  # noqa: E402


def offset_share():
    for m, k, n, gs in ((2048, 7168, 512, 32), (768, 3072, 512, 32), (7168, 2048, 512, 128),
                        (768, 3072, 512, 16)):
        sets = []
        for i in range(max(2, math.ceil(cs.L2_FLUSH_BYTES / (m * k + 2 * n * k)))):
            g = torch.Generator(device="cuda").manual_seed(i)
            sets.append((torch.randn(n, k, device="cuda", generator=g).to(torch.bfloat16),
                         torch.randint(0, 256, (m, k), device="cuda", dtype=torch.uint8,
                                       generator=g),
                         torch.rand(m, k // gs, device="cuda", generator=g) * 1e-2,
                         torch.rand(m, k // gs, device="cuda", generator=g) * 1e-1))
        with_min = cs.time_graph(torch, [lambda a=a: mm.qs_gemm(*a) for a in sets])
        without = cs.time_graph(torch, [lambda a=a: mm.qs_gemm(*a[:3]) for a in sets])
        print(f"offsets, u8 codes [{m}, {k}] n={n}, groups of {gs}: with {with_min * 1e3:.2f} us, "
              f"without {without * 1e3:.2f} us, share {(with_min - without) / with_min:.3f}",
              flush=True)


def drift():
    card = torch.device("cuda")
    m, k = 768, 3072
    for form in ("Q5_K", "Q8_0", "INT8", "NF4"):
        if form in ("INT8", "NF4"):
            kernel, plain, ops = cards._requant_call(cards._requant_matrix(form, m, k, 11, card),
                                                     "gemm")
        else:
            a = cards._matrix(form, m, k, 11, card).arrays
            if form == "Q5_K":
                kernel, plain = mm.qkb_gemm, mm.qkb_gemm_plain
                ops = tuple(a[key] for key in ("codes", "sc6", "mn6", "d8", "dm8"))
            else:
                kernel, plain, ops = mm.qs_gemm, mm.qs_gemm_plain, (a["codes"], a["scales"])
        for n in (64, 512):
            x = torch.relu(cards._x(n, k, 5, card)) ** 2
            got, want = kernel(x, *ops), plain(x, *ops)
            limit = 1e-4 * want.abs().max().item()
            err = (got - want).abs().max().item()
            print(f"same-signed drift, {form} [{m}, {k}] n={n}: max|kernel - plain| {err:.3e}, "
                  f"{err / limit:.3f} of the test's limit {limit:.3e}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_gemm_probe: needs a CUDA card")
    print(f"card: {cs.nvidia_smi()}", flush=True)
    drift()
    offset_share()


if __name__ == "__main__":
    main()
