"""Synthetic random-weight RWKV-7 model files, in the GGUF layout a
converter writes — used by tests and by ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np

from ..gguf import GgufWriter
from ..quant.ggml import GgmlDType


def make_v7_gguf(
    *,
    n_layer=2,
    n_emb=32,
    head_size=8,
    n_vocab=48,
    n_hidden=None,
    lora_w=8,
    lora_a=8,
    lora_g=8,
    lora_v=8,
    seed=0,
    quantize=None,
    head_quantize=None,
    fused_lerp=False,
    dtype=np.float32,
):
    """Bytes of an RWKV-7 GGUF file with weights drawn from ``seed``.

    ``quantize`` selects the block type of the big matrices (None keeps
    them plain); ``head_quantize`` overrides it for the output head, so
    ``quantize=Q4_K, head_quantize=Q6_K`` writes the Q4_K_M placement.
    The random draws do not depend on either, so every placement of one
    seed holds the same underlying weights."""
    n_hidden = n_hidden or 4 * n_emb
    rng = np.random.default_rng(seed)
    w = GgufWriter()
    w.add_metadata("general.architecture", "rwkv7")
    w.add_metadata("rwkv7.wkv.head_size", head_size)

    def r(*shape, scale=0.5):
        return (rng.normal(size=shape) * scale).astype(dtype)

    def add(name, arr, q=False):
        w.add_tensor(name, arr, quantize=quantize if q else None)

    add("token_embd.weight", r(n_vocab, n_emb))
    add("token_embd_norm.weight", 1.0 + r(n_emb, scale=0.1))
    add("token_embd_norm.bias", r(n_emb, scale=0.1))
    add("output_norm.weight", 1.0 + r(n_emb, scale=0.1))
    add("output_norm.bias", r(n_emb, scale=0.1))
    w.add_tensor("output.weight", r(n_vocab, n_emb),
                 quantize=head_quantize if head_quantize is not None else quantize)

    for i in range(n_layer):
        p = f"blk.{i}"
        add(f"{p}.attn_norm.weight", 1.0 + r(n_emb, scale=0.1))
        add(f"{p}.attn_norm.bias", r(n_emb, scale=0.1))
        add(f"{p}.attn_norm_2.weight", 1.0 + r(n_emb, scale=0.1))
        add(f"{p}.attn_norm_2.bias", r(n_emb, scale=0.1))

        if fused_lerp:
            fused = r(6, n_emb)
            w.add_raw_tensor(
                f"{p}.time_mix_lerp_fused.weight",
                (n_emb, 1, 1, 6),
                GgmlDType.F32 if dtype == np.float32 else GgmlDType.F16,
                fused.tobytes(),
            )
        else:
            for s in "rwkvag":
                add(f"{p}.att_x_{s}", r(n_emb))

        add(f"{p}.time_mix_w0.weight", r(n_emb))
        add(f"{p}.time_mix_w1.weight", r(lora_w, n_emb))
        add(f"{p}.time_mix_w2.weight", r(n_emb, lora_w))
        add(f"{p}.time_mix_a0.weight", r(n_emb))
        add(f"{p}.time_mix_a1.weight", r(lora_a, n_emb))
        add(f"{p}.time_mix_a2.weight", r(n_emb, lora_a))
        add(f"{p}.time_mix_g1.weight", r(lora_g, n_emb))
        add(f"{p}.time_mix_g2.weight", r(n_emb, lora_g))
        if i > 0:
            add(f"{p}.time_mix_v0.weight", r(n_emb))
            add(f"{p}.time_mix_v1.weight", r(lora_v, n_emb))
            add(f"{p}.time_mix_v2.weight", r(n_emb, lora_v))
        add(f"{p}.time_mix_r_k.weight", r(n_emb))
        add(f"{p}.time_mix_k_k.weight", r(n_emb))
        add(f"{p}.time_mix_k_a.weight", r(n_emb))
        add(f"{p}.time_mix_ln.weight", 1.0 + r(n_emb, scale=0.1))
        add(f"{p}.time_mix_ln.bias", r(n_emb, scale=0.1))

        add(f"{p}.time_mix_key.weight", r(n_emb, n_emb), q=True)
        add(f"{p}.time_mix_value.weight", r(n_emb, n_emb), q=True)
        add(f"{p}.time_mix_receptance.weight", r(n_emb, n_emb), q=True)
        add(f"{p}.time_mix_output.weight", r(n_emb, n_emb), q=True)

        add(f"{p}.channel_mix_lerp_k.weight", r(n_emb))
        add(f"{p}.channel_mix_key.weight", r(n_hidden, n_emb), q=True)
        add(f"{p}.channel_mix_value.weight", r(n_emb, n_hidden), q=True)
    return w.tobytes()
