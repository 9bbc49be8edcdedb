"""Per-kernel micro-benchmark: µs and effective GFLOP/s of the dequant
matmul kernels against a dense bf16 product (ref:
examples/bench_q4k_shaders.rs — warmup 10, runs 100).

``Matrix.matmul`` takes the port's kernels by weight form and row count
N (on the card: the Q4_K gemv or dequant-GEMM, the f32-scale gemv or
GEMM for Q8_0 and Int8; on the CPU their plain versions); ``dense_bf16``
is one ``torch.matmul``. Each N is timed over ``--runs`` calls after
``--warmup``, from the host's clock with the device synchronised
(``utils.trace.device_sync``)."""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--m", type=int, default=2688)
    p.add_argument("--k", type=int, default=768)
    p.add_argument("--n", type=int, action="append", default=None)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run: the CUDA card or the CPU (their plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)

    import torch

    from . import common
    from ..models.matrix import Matrix
    from ..quant.formats import QuantScheme
    from ..quant.ggml import GgmlDType, quantize_q4_k, quantize_q8_0
    from ..utils.trace import device_sync

    dev = common.device(args)
    M, K = args.m, args.k
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(M, K)) * 0.1).astype(np.float32)

    mats = {
        "dense_bf16": Matrix.dense(torch.from_numpy(w).to(dev, torch.bfloat16)),
        "q4_k": Matrix.from_gguf_blocks(
            GgmlDType.Q4_K, np.frombuffer(quantize_q4_k(w.reshape(-1)), np.uint8), (M, K),
            device=dev),
        "q8_0": Matrix.from_gguf_blocks(
            GgmlDType.Q8_0, np.frombuffer(quantize_q8_0(w.reshape(-1)), np.uint8), (M, K),
            device=dev),
        "int8": Matrix.from_f16(w.astype(np.float16), QuantScheme.INT8, device=dev),
    }

    kind = torch.cuda.get_device_name(dev) if dev == "cuda" else "cpu"
    print(f"matmul [{M}x{K}] on {kind}")
    print(f"{'kernel':12} {'N':>4} {'us':>9} {'GFLOP/s':>9} {'wbytes':>9}")
    for name, mat in mats.items():
        wbytes = sum(a.numel() * a.element_size() for a in mat.arrays.values())
        if mat.kind == "dense":
            call = lambda x, w=mat.arrays["w"]: torch.matmul(x, w.T)  # noqa: E731
        else:
            call = mat.matmul
        for N in args.n or [1, 8, 64, 256]:
            x = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(
                dev, torch.bfloat16)
            device_sync(call(x))
            for _ in range(args.warmup):
                call(x)
            device_sync(call(x))
            t0 = time.perf_counter()
            outs = [call(x) for _ in range(args.runs)]
            device_sync(outs[-1])
            dt = (time.perf_counter() - t0) / args.runs
            gflops = 2 * N * M * K / dt / 1e9
            print(f"{name:12} {N:4d} {dt*1e6:9.1f} {gflops:9.1f} {wbytes:9d}")


if __name__ == "__main__":
    main()
