"""Convert RWKV checkpoints (.pth / .st) to GGUF
(ref: assets/scripts/convert_hf_to_gguf.py + convert_safetensors.py).

Handles the reference converter's v7 conventions: the six token-shift
lerp vectors are stacked into ``time_mix_lerp_fused``, inner-LoRA
matrices are transposed to model convention, ``r_k`` is flattened with
``rwkv7.wkv.head_size`` metadata, and layer-0 emits no v0/v1/v2
(ref: convert_hf_to_gguf.py:598-634).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..gguf import GgufWriter
from ..quant.ggml import GGML_BLOCK_SIZES, GgmlDType

_V7_SHORT_TO_GGUF = {
    "att.key.weight": "time_mix_key.weight",
    "att.value.weight": "time_mix_value.weight",
    "att.receptance.weight": "time_mix_receptance.weight",
    "att.output.weight": "time_mix_output.weight",
    "att.w0": "time_mix_w0.weight",
    "att.w1": "time_mix_w1.weight",
    "att.w2": "time_mix_w2.weight",
    "att.a0": "time_mix_a0.weight",
    "att.a1": "time_mix_a1.weight",
    "att.a2": "time_mix_a2.weight",
    "att.g1": "time_mix_g1.weight",
    "att.g2": "time_mix_g2.weight",
    "att.v0": "time_mix_v0.weight",
    "att.v1": "time_mix_v1.weight",
    "att.v2": "time_mix_v2.weight",
    "att.r_k": "time_mix_r_k.weight",
    "att.k_k": "time_mix_k_k.weight",
    "att.k_a": "time_mix_k_a.weight",
    "att.ln_x.weight": "time_mix_ln.weight",
    "att.ln_x.bias": "time_mix_ln.bias",
    "ffn.key.weight": "channel_mix_key.weight",
    "ffn.value.weight": "channel_mix_value.weight",
    "ffn.x_k": "channel_mix_lerp_k.weight",
    "ln1.weight": "attn_norm.weight",
    "ln1.bias": "attn_norm.bias",
    "ln2.weight": "attn_norm_2.weight",
    "ln2.bias": "attn_norm_2.bias",
}

# generic per-block mapping for v4/v5/v6 checkpoints
_GENERIC_TO_GGUF = {
    "ln1.weight": "attn_norm.weight",
    "ln1.bias": "attn_norm.bias",
    "ln2.weight": "ffn_norm.weight",
    "ln2.bias": "ffn_norm.bias",
    "att.key.weight": "attn_k.weight",
    "att.value.weight": "attn_v.weight",
    "att.receptance.weight": "attn_r.weight",
    "att.gate.weight": "attn_g.weight",
    "att.output.weight": "attn_output.weight",
    "att.time_decay": "attn_time_decay",
    "att.time_first": "attn_time_first",
    "att.time_faaaa": "attn_time_first",
    "att.time_mix_k": "attn_time_mix_k",
    "att.time_mix_v": "attn_time_mix_v",
    "att.time_mix_r": "attn_time_mix_r",
    "att.time_mix_g": "attn_time_mix_g",
    "att.time_mix_x": "attn_time_mix_x",
    "att.time_mix_w": "attn_time_mix_w",
    "att.time_maa_x": "attn_time_mix_x",
    "att.time_maa_w": "attn_time_mix_w",
    "att.time_maa_k": "attn_time_mix_k",
    "att.time_maa_v": "attn_time_mix_v",
    "att.time_maa_r": "attn_time_mix_r",
    "att.time_maa_g": "attn_time_mix_g",
    "att.time_maa_w1": "attn_time_mix_w1",
    "att.time_maa_w2": "attn_time_mix_w2",
    "att.time_decay_w1": "attn_time_decay_w1",
    "att.time_decay_w2": "attn_time_decay_w2",
    "att.ln_x.weight": "attn_ln_x.weight",
    "att.ln_x.bias": "attn_ln_x.bias",
    "ffn.key.weight": "ffn_k.weight",
    "ffn.value.weight": "ffn_v.weight",
    "ffn.receptance.weight": "ffn_r.weight",
    "ffn.time_mix_k": "ffn_time_mix_k",
    "ffn.time_mix_r": "ffn_time_mix_r",
    "ffn.time_maa_k": "ffn_time_mix_k",
    "ffn.time_maa_r": "ffn_time_mix_r",
}

_QUANT_OK = {"att", "ffn", "output"}  # only 2-D projection weights quantize


def load_checkpoint(path) -> dict[str, np.ndarray]:
    """A ``.pth`` (``torch.load(weights_only=True)``) or ``.st`` checkpoint
    as f32 numpy arrays by name."""
    path = Path(path)
    if path.suffix in (".st", ".safetensors"):
        from ..io.safetensors import SafetensorsFile

        f = SafetensorsFile(path)
        return {n: f.tensor(n, np.float32) for n in f.names()}
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def detect_version(sd) -> str:
    if any(".att.x_r" in k or ".att.w0" in k for k in sd):
        return "v7"
    if any("time_maa_w1" in k or "time_mix_w1" in k for k in sd):
        return "v6"
    if any(".att.gate.weight" in k or ".att.ln_x.weight" in k for k in sd):
        return "v5"
    return "v4"


def convert(sd: dict[str, np.ndarray], outtype: str = "f16") -> GgufWriter:
    version = detect_version(sd)
    n_layer = 1 + max(
        (int(k.split(".")[1]) for k in sd if k.startswith("blocks.")), default=0
    )
    n_emb = sd["emb.weight"].shape[1]
    n_vocab = sd["emb.weight"].shape[0]

    head_size = None
    if version == "v7":
        rk = next(v for k, v in sd.items() if k.endswith("att.r_k"))
        head_size = rk.shape[-1] if rk.ndim == 2 else 64
    elif version in ("v5", "v6"):
        tf = next(
            v for k, v in sd.items()
            if k.endswith(("att.time_first", "att.time_faaaa"))
        )
        head_size = tf.shape[-1] if tf.ndim >= 2 else 64

    w = GgufWriter()
    w.add_metadata("general.architecture", f"rwkv{version[1]}")
    w.add_metadata("general.name", "converted by web-rwkv-gguf-tpu")
    w.add_metadata(f"rwkv{version[1]}.embedding_length", n_emb)
    w.add_metadata(f"rwkv{version[1]}.block_count", n_layer)
    w.add_metadata(f"rwkv{version[1]}.context_length", 1048576)
    if head_size:
        w.add_metadata(f"rwkv{version[1]}.wkv.head_size", int(head_size))

    quantize = {
        "f32": None, "f16": None, "q8_0": GgmlDType.Q8_0, "q4_k": GgmlDType.Q4_K,
        "q5_k": GgmlDType.Q5_K, "q6_k": GgmlDType.Q6_K,
        "q3_k": GgmlDType.Q3_K, "q2_k": GgmlDType.Q2_K,
        "q4_0": GgmlDType.Q4_0, "q4_1": GgmlDType.Q4_1,
        "q5_0": GgmlDType.Q5_0, "q5_1": GgmlDType.Q5_1,
    }[outtype]
    cast = np.float32 if outtype == "f32" else np.float16

    # ggml requires a quantized tensor's row length to divide its block
    # size: 256 for K-quants, 32 for Q8_0 and the legacy formats (so a
    # [768, 2688] ffn value matrix quantizes at q8_0/q4_0/... where the
    # 256 gate would leave it f16)
    qblock = GGML_BLOCK_SIZES[quantize] if quantize else 1

    def emit(name, arr, quantizable=False):
        arr = np.asarray(arr, np.float32)
        if arr.ndim >= 2:
            arr = arr.squeeze() if arr.ndim > 2 and 1 in arr.shape else arr
        q = quantize if (quantizable and arr.ndim == 2 and quantize
                         and arr.shape[-1] % qblock == 0) else None
        if q is None:
            w.add_tensor(name, arr.astype(cast))
        else:
            w.add_tensor(name, arr, quantize=q)

    emit("token_embd.weight", sd["emb.weight"])
    if "blocks.0.ln0.weight" in sd:
        emit("token_embd_norm.weight", sd["blocks.0.ln0.weight"])
        emit("token_embd_norm.bias", sd["blocks.0.ln0.bias"])
    emit("output_norm.weight", sd["ln_out.weight"])
    emit("output_norm.bias", sd["ln_out.bias"])
    emit("output.weight", sd["head.weight"], quantizable=True)

    for i in range(n_layer):
        pre = f"blocks.{i}."
        blk = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        blk.pop("ln0.weight", None)
        blk.pop("ln0.bias", None)

        if version == "v7":
            # fuse the six token-shift lerps (ref: convert_hf_to_gguf.py:598-609)
            fused = np.stack(
                [blk.pop(f"att.x_{s}").reshape(-1) for s in "rwkvag"]
            ).astype(cast)
            w.add_raw_tensor(
                f"blk.{i}.time_mix_lerp_fused.weight",
                (n_emb, 1, 1, 6),
                GgmlDType.F32 if cast == np.float32 else GgmlDType.F16,
                np.ascontiguousarray(fused).tobytes(),
            )
            for short, gguf_name in _V7_SHORT_TO_GGUF.items():
                if short not in blk:
                    continue
                arr = blk.pop(short)
                if short in ("att.w1", "att.w2", "att.a1", "att.a2", "att.g1",
                             "att.g2", "att.v1", "att.v2") and arr.ndim == 2:
                    # pth stores x@w1 layout [in, out]; GGUF wants [out, in]
                    arr = arr.T
                if short == "att.r_k":
                    arr = arr.reshape(-1)
                if short in ("att.w0", "att.a0", "att.v0", "att.k_k", "att.k_a"):
                    arr = arr.reshape(-1)
                quantizable = short.endswith(".weight") and any(
                    s in short for s in ("key", "value", "receptance", "output")
                )
                emit(f"blk.{i}.{gguf_name}", arr, quantizable)
        else:
            for short, gguf_name in _GENERIC_TO_GGUF.items():
                if short not in blk:
                    continue
                arr = blk.pop(short)
                if short in ("att.time_maa_w1", "att.time_mix_w1",
                             "att.time_decay_w1", "att.time_decay_w2") and arr.ndim == 2:
                    arr = arr.T
                if short in ("att.time_maa_w2", "att.time_mix_w2") and arr.ndim == 3:
                    arr = arr.transpose(0, 2, 1)
                if (
                    arr.ndim > 1
                    and gguf_name.startswith(("attn_time_mix", "ffn_time_mix"))
                    and not gguf_name.endswith(("w1", "w2"))
                ):
                    arr = arr.reshape(-1)
                quantizable = gguf_name.endswith(".weight") and "norm" not in gguf_name
                emit(f"blk.{i}.{gguf_name}", arr, quantizable)

        for leftover in blk:
            print(f"  [skip] blocks.{i}.{leftover}")
    return w


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help=".pth or .st checkpoint")
    p.add_argument("--output", required=True)
    p.add_argument("--outtype", default="f16",
                   choices=["f32", "f16", "q8_0", "q4_k", "q5_k", "q6_k", "q3_k", "q2_k",
                            "q4_0", "q4_1", "q5_0", "q5_1"])
    p.add_argument(
        "--format", default=None, choices=["gguf", "st"],
        help="output container (default: from output extension; 'st' mirrors "
             "the reference's convert_safetensors.py pth->st path)",
    )
    args = p.parse_args(argv)

    sd = load_checkpoint(args.input)
    print(f"{len(sd)} tensors, detected {detect_version(sd)}")
    fmt = args.format or ("st" if args.output.endswith((".st", ".safetensors")) else "gguf")
    if fmt == "st":
        from ..io.safetensors import write_safetensors

        cast = np.float32 if args.outtype == "f32" else np.float16
        write_safetensors(
            args.output,
            {k: np.asarray(v).squeeze().astype(cast) if np.asarray(v).ndim > 2
             else np.asarray(v, cast) for k, v in sd.items()},
        )
    else:
        writer = convert(sd, args.outtype)
        writer.write(args.output)
    print(f"wrote {args.output}: {Path(args.output).stat().st_size/1e6:.1f} MB")


if __name__ == "__main__":
    main()
