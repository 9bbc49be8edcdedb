"""Synthetic random-weight RWKV-7, -6, -5 and -4 model files, in the GGUF
layout a converter writes — used by tests and by ``chip_smoke.py``."""

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


def make_v6_gguf(
    *, n_layer=2, n_emb=16, head_size=4, n_vocab=32, n_hidden=None, rank_tm=4,
    rank_td=8, seed=0, quantize=None, head_quantize=None, dtype=np.float32,
):
    """Bytes of an RWKV-6 GGUF file with weights drawn from ``seed``
    (the draws, names and order of the JAX package's ``make_v6_gguf``).

    ``quantize`` selects the block type of the eight layer matrices and
    the head; ``head_quantize`` overrides it for the head, so
    ``quantize=Q4_K, head_quantize=Q6_K`` writes the Q4_K_M placement.
    ``dtype`` (f32 or f16) is the type of every tensor left plain."""
    n_hidden = n_hidden or 4 * n_emb
    n_head = n_emb // head_size
    rng = np.random.default_rng(seed)
    w = GgufWriter()
    w.add_metadata("rwkv6.wkv.head_size", head_size)

    def r(*shape, scale=0.5):
        return (rng.normal(size=shape) * scale).astype(dtype)

    def uniform():
        return rng.uniform(0, 1, n_emb).astype(dtype)

    def addq(name, arr):
        w.add_tensor(name, arr, quantize=quantize)

    w.add_tensor("token_embd.weight", r(n_vocab, n_emb))
    w.add_tensor("token_embd_norm.weight", 1.0 + r(n_emb, scale=0.1))
    w.add_tensor("token_embd_norm.bias", r(n_emb, scale=0.1))
    w.add_tensor("output_norm.weight", 1.0 + r(n_emb, scale=0.1))
    w.add_tensor("output_norm.bias", r(n_emb, scale=0.1))
    w.add_tensor("output.weight", r(n_vocab, n_emb),
                 quantize=head_quantize if head_quantize is not None else quantize)
    for i in range(n_layer):
        p = f"blk.{i}"
        w.add_tensor(f"{p}.attn_norm.weight", 1.0 + r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_norm.bias", r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.ffn_norm.weight", 1.0 + r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.ffn_norm.bias", r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_time_decay", r(n_head, head_size))
        w.add_tensor(f"{p}.attn_time_first", r(n_head, head_size))
        w.add_tensor(f"{p}.attn_time_mix_x", uniform())
        for s in "wkvrg":
            w.add_tensor(f"{p}.attn_time_mix_{s}", uniform())
        w.add_tensor(f"{p}.attn_time_mix_w1", r(5 * rank_tm, n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_time_mix_w2", r(5, n_emb, rank_tm, scale=0.1))
        w.add_tensor(f"{p}.attn_time_decay_w1", r(rank_td, n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_time_decay_w2", r(n_emb, rank_td, scale=0.1))
        for name in ("attn_k", "attn_v", "attn_r", "attn_g", "attn_output"):
            addq(f"{p}.{name}.weight", r(n_emb, n_emb))
        w.add_tensor(f"{p}.attn_ln_x.weight", 1.0 + r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_ln_x.bias", r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.ffn_time_mix_k", uniform())
        w.add_tensor(f"{p}.ffn_time_mix_r", uniform())
        addq(f"{p}.ffn_k.weight", r(n_hidden, n_emb))
        addq(f"{p}.ffn_v.weight", r(n_emb, n_hidden))
        addq(f"{p}.ffn_r.weight", r(n_emb, n_emb))
    return w.tobytes()


def make_v5_gguf(*, n_layer=2, n_emb=16, head_size=4, n_vocab=32, n_hidden=None, seed=0,
                 quantize=None, head_quantize=None):
    """Bytes of an RWKV-5 GGUF file with weights drawn from ``seed`` (the
    draws, names and order of the JAX package's ``make_v5_gguf``, which
    writes every tensor in f32).

    ``quantize`` selects the block type of the eight layer matrices and
    the head; ``head_quantize`` overrides it for the head. With neither,
    the bytes are the JAX package's."""
    n_hidden = n_hidden or 4 * n_emb
    n_head = n_emb // head_size
    rng = np.random.default_rng(seed)
    w = GgufWriter()

    def r(*shape, scale=0.5):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def uniform():
        return rng.uniform(0, 1, n_emb).astype(np.float32)

    def addq(name, arr):
        w.add_tensor(name, arr, quantize=quantize)

    w.add_tensor("token_embd.weight", r(n_vocab, n_emb))
    w.add_tensor("token_embd_norm.weight", 1.0 + r(n_emb, scale=0.1))
    w.add_tensor("token_embd_norm.bias", r(n_emb, scale=0.1))
    w.add_tensor("output_norm.weight", 1.0 + r(n_emb, scale=0.1))
    w.add_tensor("output_norm.bias", r(n_emb, scale=0.1))
    w.add_tensor("output.weight", r(n_vocab, n_emb),
                 quantize=head_quantize if head_quantize is not None else quantize)
    for i in range(n_layer):
        p = f"blk.{i}"
        w.add_tensor(f"{p}.attn_norm.weight", 1.0 + r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_norm.bias", r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.ffn_norm.weight", 1.0 + r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.ffn_norm.bias", r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_time_decay", r(n_head, head_size))
        w.add_tensor(f"{p}.attn_time_first", r(n_head, head_size))
        for s in "kvrg":
            w.add_tensor(f"{p}.attn_time_mix_{s}", uniform())
        for name in ("attn_k", "attn_v", "attn_r", "attn_g", "attn_output"):
            addq(f"{p}.{name}.weight", r(n_emb, n_emb))
        w.add_tensor(f"{p}.attn_ln_x.weight", 1.0 + r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_ln_x.bias", r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.ffn_time_mix_k", uniform())
        w.add_tensor(f"{p}.ffn_time_mix_r", uniform())
        addq(f"{p}.ffn_k.weight", r(n_hidden, n_emb))
        addq(f"{p}.ffn_v.weight", r(n_emb, n_hidden))
        addq(f"{p}.ffn_r.weight", r(n_emb, n_emb))
    return w.tobytes()


def make_v4_gguf(*, n_layer=2, n_emb=16, n_vocab=32, n_hidden=None, seed=0, quantize=None,
                 head_quantize=None):
    """Bytes of an RWKV-4 GGUF file with weights drawn from ``seed`` (the
    draws, names and order of the JAX package's ``make_v4_gguf``).

    ``quantize`` selects the block type of the seven layer matrices and
    the head; ``head_quantize`` overrides it for the head. Without
    ``head_quantize``, the bytes are the JAX package's for the same
    ``quantize``."""
    n_hidden = n_hidden or 4 * n_emb
    rng = np.random.default_rng(seed)
    w = GgufWriter()
    w.add_metadata("general.architecture", "rwkv")

    def r(*shape, scale=0.5):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def uniform():
        return rng.uniform(0, 1, n_emb).astype(np.float32)

    def addq(name, arr):
        w.add_tensor(name, arr, quantize=quantize)

    w.add_tensor("token_embd.weight", r(n_vocab, n_emb))
    w.add_tensor("token_embd_norm.weight", 1.0 + r(n_emb, scale=0.1))
    w.add_tensor("token_embd_norm.bias", r(n_emb, scale=0.1))
    w.add_tensor("output_norm.weight", 1.0 + r(n_emb, scale=0.1))
    w.add_tensor("output_norm.bias", r(n_emb, scale=0.1))
    w.add_tensor("output.weight", r(n_vocab, n_emb),
                 quantize=head_quantize if head_quantize is not None else quantize)
    for i in range(n_layer):
        p = f"blk.{i}"
        w.add_tensor(f"{p}.attn_norm.weight", 1.0 + r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_norm.bias", r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.ffn_norm.weight", 1.0 + r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.ffn_norm.bias", r(n_emb, scale=0.1))
        w.add_tensor(f"{p}.attn_time_decay", r(n_emb))
        w.add_tensor(f"{p}.attn_time_first", r(n_emb))
        for s in "kvr":
            w.add_tensor(f"{p}.attn_time_mix_{s}", uniform())
        for name in ("attn_k", "attn_v", "attn_r", "attn_output"):
            addq(f"{p}.{name}.weight", r(n_emb, n_emb))
        w.add_tensor(f"{p}.ffn_time_mix_k", uniform())
        w.add_tensor(f"{p}.ffn_time_mix_r", uniform())
        addq(f"{p}.ffn_k.weight", r(n_hidden, n_emb))
        addq(f"{p}.ffn_v.weight", r(n_emb, n_hidden))
        addq(f"{p}.ffn_r.weight", r(n_emb, n_emb))
    return w.tobytes()
