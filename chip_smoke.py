#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py v7q5,v6q8`` runs only the models named, tags of
``MODELS``, in that order.)

It builds every CUDA kernel of the port from ``web_rwkv_gguf_tpu_torch/
ops/cuda/csrc`` with nvcc (one nvcc per source, all started together),
holds each kernel against its plain PyTorch version at the shapes the
decode and prefill paths give it and times both (and, where one PyTorch
call computes the same product, that call). Then it drives the port's
main paths on eleven synthetic models, one after the other, each path
with every kernel's launch count set to 0 just before and checked
exactly just after:

- in the Q4_K_M placement, RWKV-7 at the 0.1B widths, RWKV-6 at the
  World 1.6B widths, RWKV-5 at the World 0.4B widths and RWKV-4 at the
  World 0.1B widths; RWKV-7 at the 0.1B widths in the Q5_K_M placement
  and RWKV-6 at the World 1.6B widths in Q8_0; f16 files requantized at
  load, RWKV-7 at the 0.1B widths in Int8 and in NF4 and RWKV-6 at the
  World 1.6B widths in Int8; RWKV-7 at the 0.1B widths in Q6_K
  throughout and from an f16 file loaded as bf16 (table ``MODELS``; full
  depth but where it says otherwise; the files are built in worker
  processes while the kernels build);
- serve two requests at batch 1 through ``forward_chunk`` (each prompt
  prefilled as one chunk) → ``logits_head`` → ``make_generator``, on
  the loaded params, or for an RWKV-7 model whose r, k and v group on
  ``models.unroll_params(params)``, the JAX package's unrolled decode
  form, where each layer's r, k and v take one ``quant_gemv_grouped``
  launch (the per-layer kernels at decode);
- ``runtime.Engine(num_batch=4)`` under the default dense-prefill policy
  (chunks of at least 64 tokens on a dense bf16 copy where it clearly
  fits; the Q8_0 model's Engine without the copy): ``generate`` on four
  prompts of different lengths (chunked prefill as the scheduler plans
  it, then 32 greedy tokens on all lanes, each step one launch of the
  whole-stack decode kernel, or the per-layer path for NF4, which has
  none), then one ``infer`` with a FULL lane;
- serving (RWKV-7 Q4_K_M, RWKV-6 Q4_K_M): the prefill with and without
  the dense copy, timed, and held against each other on the card-vs-CPU
  model's two layers; an ``runtime.EnginePool`` of 32 lanes (two engines
  of 16 decoding on dense weights in the whole-stack kernel's dense
  slot, one params object, one dense copy while it is built) against two
  standalone engines, timed beside one engine of 16 lanes; dense against
  quantized decode at 16 lanes on the two layers; an RWKV-6 Engine of 8
  lanes decoding one step in the dense slot;
- files: a lane's state through ``io.save_state`` / ``io.load_state``
  (RWKV-7, RWKV-4), a file's ``time_state`` through
  ``models.load_initial_state``, a ``.rwkvz`` snapshot of the NF4 model
  and a ``.safetensors`` file of the bf16 model, each loaded back bit
  for bit;
- the model surface: ``Engine(hooks=)`` with a tap on every name (RWKV-7:
  a hooked chunk bit for bit against the unhooked one, then the hooked
  decode, counted and profiled) or an example's hook (RWKV-6's
  puzzle15), embedding vectors as Engine input, ``runtime.infer_vision``,
  ``load_model(lora=)`` (dense and NF4, and on layer 0 alone of a
  quantized file) and ``GgufFile(allow_quantized_direct=False)``; the
  example hooks, vision, the LoRA loads and the direct load also on the
  card-vs-CPU model against the CPU;
- the apps (``web_rwkv_gguf_tpu_torch/apps``), each through its ``main``
  on the model's file and a byte-level vocabulary built here: gen per
  token and fused, batch, chat (retry and reset), ppl and ppl
  --compare-f16, serde then gen from the snapshot, inspect, othello and
  convert (a checkpoint written by torch.save, converted to q8_0 in a
  worker process, one Engine step on it) on RWKV-7 Q4_K_M, puzzle15 on
  RWKV-6, gen --quant nf4 on the NF4 model's f16 file; gen under
  ``utils.trace.trace_to``; the native library's load against numpy's;
  ppl's nll on the card against the CPU on the two-layer model.

For each model it holds the whole-stack decode kernel against its plain
version layer by layer (and, beside the Q6_K and f16 models, stacks in
the slots no driven model reaches: RWKV-7 at the 0.1B widths in Q3_K and
Q4_1, RWKV-6 at the 1.6B widths in Q6_K, Q4_0 and bf16, at 4 of its 24
layers; ``SLOT_STACKS``), and compares the card with the CPU at the same
widths (two layers, three lanes): decode steps with a lane frozen,
through the per-layer kernels and through the whole-stack kernel, and a
ragged prefill chunk followed by one of 128 tokens; it also measures how
far the card and the CPU each move under one-ulp product changes
(decode steps and prefill, on the per-layer path), and holds the
dequant-GEMM call with offsets of those decode steps that lies furthest
from its plain version as a kernel case of its own, on the model's own
activations. Every comparison of
a model prints before a failed one raises, so the exit code is not 0.
The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON line of per-kernel numbers, and ``{"ok": true, "device": {...}}``.

With no CUDA card, or outside a checkout, it exits non-zero at once and
prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import io
import itertools
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

VOCAB = 65536  # every model's vocabulary
# RWKV-7 0.1B widths (L=12, C=768, head 64, hidden 4·C, LoRA ranks w/a/g/v
# 64/64/128/32) and a layer's six matrices
_V7_WIDTHS = dict(n_layer=12, n_emb=768, head_size=64, n_vocab=VOCAB, n_hidden=3072,
                  lora_w=64, lora_a=64, lora_g=128, lora_v=32)
_V7_MATRICES = (("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wo"), ("ffn", "Wk"),
                ("ffn", "Wv"))
_RKV = (("att", "Wr"), ("att", "Wk"), ("att", "Wv"))  # the grouped gemv's matrices
_V6_MATRICES = (("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wg"), ("att", "Wo"),
                ("ffn", "Wk"), ("ffn", "Wv"), ("ffn", "Wr"))
# The models under test, in the order they run: each a synthetic file at
# full depth with random weights from its seed (the card-vs-CPU model at
# COMPARE_LAYERS layers from seed + 1, or "compare_seed"), its matrices quantized as
# "quantize" (layers) and "head_quantize" (the head) say: the Q4_K_M
# placement (Q4_K layers, Q6_K head), the Q5_K_M placement (Q5_K layers,
# Q6_K head) or Q8_0 throughout; or an f16 file ("quantize" None) that
# load_model requantizes by "quant" (Int8, NF4: every layer matrix, the
# head stays dense bf16). "kinds" are the Matrix kinds the layers
# and the head load as. "matrices" are a layer's quantized matrices; "wkv" the kernel
# that runs a layer's WKV in a per-layer forward chunk at T = 1, at
# 2 <= T < 128 and at T >= 128 (None: the chunk-parallel form, PyTorch
# matmuls); "mega" the whole-stack decode blocks and their kernel, held
# layer by layer at each of "mega_batches" lanes (None: the model has no
# whole-stack form, and the Engine decodes layer by layer). "grouped": an
# RWKV-7 model whose r, k and v group (models.unroll_params attaches
# att["Wrkv_g"] to every layer), served at B=1 on the unrolled params.
# MODEL_CASES holds each model's kernel cases. The serving and file phases
# run where a model says so: "engine", the Engine's arguments (the Q8_0
# model prefills without the dense copy, so the dequant-GEMM keeps an Engine
# path of its own at every chunk); "dense_compare", the prefill on the
# dense copy against an Engine without it; "dense8", an Engine of 8 lanes
# decoding on dense weights; "pool", an EnginePool of POOL_LANES lanes;
# "state_file", a lane through a state file; "initial_state", a file's
# time_state; "snapshot", a .rwkvz snapshot; "safetensors", a .safetensors
# file of the model. The model surface: "hooks", the
# Engine with taps (RWKV-7: every tap observed, a hooked chunk against the
# unhooked one bit for bit, the hooked decode counted and profiled) and the
# modifying pair of the named example (HOOK_EXAMPLES) against the CPU;
# "embeds", embedding vectors as Engine input (Token::Embed); "vision",
# infer_vision; "direct", the file loaded with allow_quantized_direct=False;
# "lora", LoRA merged at load, dense and with NF4; "lora_layer0", a LoRA on
# layer 0 alone of a quantized file (per-layer blocks). "apps": the parts of
# the apps phase the model runs (see APP_PROMPT).
MODELS = {
    # RWKV-7 0.1B widths (L=12, C=768, head 64, hidden 4·C, LoRA ranks
    # w/a/g/v 64/64/128/32)
    "v7": dict(make="make_v7_gguf", seed=0, quantize="Q4_K", head_quantize="Q6_K",
               kinds=("qk", "qk_nomin"), grouped=True,
               widths=dict(n_layer=12, n_emb=768, head_size=64, n_vocab=VOCAB, n_hidden=3072,
                           lora_w=64, lora_a=64, lora_g=128, lora_v=32),
               matrices=(("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wo"),
                         ("ffn", "Wk"), ("ffn", "Wv")),
               wkv=("att_core7_step", "wkv7_scan", None), mega=("mega7", "layer_scan7"),
               mega_batches=(4, 1, 16), dense_compare=True, pool=True, state_file=True,
               initial_state=True, hooks="othello", embeds=True, vision=True, direct=True,
               lora_layer0=True, apps=("gen", "batch", "chat", "ppl", "serde", "inspect",
                                       "othello", "trace", "native", "convert")),
    # RWKV-6 World 1.6B widths (BlinkDL's RWKV-x060-World-1B6: L=24, C=2048,
    # head 64, hidden int(3.5·C // 32 · 32); time-mix and decay LoRA ranks 32
    # and 64 from RWKV-LM's v6 model.py)
    "v6": dict(make="make_v6_gguf", seed=10, quantize="Q4_K", head_quantize="Q6_K",
               kinds=("qk", "qk_nomin"),
               # 6 of the model's 24 layers (12 until the apps phase came), and
               # the run stays within its time
               widths=dict(n_layer=6, n_emb=2048, head_size=64, n_vocab=VOCAB, n_hidden=7168,
                           rank_tm=32, rank_td=64),
               matrices=_V6_MATRICES, wkv=("wkv6_scan", "wkv6_scan", None),
               mega=("mega56", "layer_scan56"), mega_batches=(4, 1, 16), dense_compare=True,
               dense8=True, hooks="puzzle15", apps=("puzzle15",)),
    # RWKV-5 World 0.4B widths (BlinkDL's RWKV-5-World-0.4B-v2: L=24, C=1024,
    # head 64, hidden int(3.5·C // 32 · 32) from RWKV-LM's v5 train.py); the
    # WKV is RWKV-6's with the static decay broadcast over the tokens
    "v5": dict(make="make_v5_gguf", seed=20, quantize="Q4_K", head_quantize="Q6_K",
               kinds=("qk", "qk_nomin"),
               # 6 of the model's 24 layers (12 until the apps phase came): beside
               # the serving, file and apps phases, the run stays within its time
               widths=dict(n_layer=6, n_emb=1024, head_size=64, n_vocab=VOCAB, n_hidden=3584),
               matrices=_V6_MATRICES, wkv=("wkv6_scan", "wkv6_scan", None),
               mega=("mega56", "layer_scan56"), mega_batches=(4, 1, 16)),
    # RWKV-4 World 0.1B widths (BlinkDL's RWKV-4-World-0.1B: L=12, C=768,
    # hidden 4·C); no chunk-parallel WKV: the scan at every T
    "v4": dict(make="make_v4_gguf", seed=30, quantize="Q4_K", head_quantize="Q6_K",
               kinds=("qk", "qk_nomin"),
               widths=dict(n_layer=12, n_emb=768, n_vocab=VOCAB, n_hidden=3072),
               matrices=(("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wo"),
                         ("ffn", "Wk"), ("ffn", "Wv"), ("ffn", "Wr")),
               wkv=("wkv4_scan",) * 3, mega=("mega56", "layer_scan56"),
               mega_batches=(4, 1, 16), state_file=True),
    # RWKV-7 0.1B widths in llama.cpp's Q5_K_M placement, made uniform
    # across layers as the Q4_K_M one is (Q5_K layers, Q6_K head)
    # Its card-vs-CPU model is seed 42's, not seed + 1's: seed 41's model
    # reads past the limits with no kernel of the port at all (the JAX
    # package's kernels in interpret mode against the port's plain versions,
    # both on the CPU: tests/test_torch_kquants_decode.py::
    # test_q5km_compare_model_against_jax), and on the card every kernel call
    # of its run holds against its plain version on its own inputs
    # (scripts/torch_trace_compare.py; PERF.md, Findings PR 5)
    "v7q5": dict(make="make_v7_gguf", seed=40, compare_seed=42, quantize="Q5_K",
                 head_quantize="Q6_K", kinds=("qk_b", "qk_nomin"), grouped=True,
                 widths=dict(n_layer=12, n_emb=768, head_size=64, n_vocab=VOCAB, n_hidden=3072,
                             lora_w=64, lora_a=64, lora_g=128, lora_v=32),
                 matrices=(("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wo"),
                           ("ffn", "Wk"), ("ffn", "Wv")),
                 wkv=("att_core7_step", "wkv7_scan", None), mega=("mega7", "layer_scan7"),
                 mega_batches=(4, 1, 16)),
    # RWKV-6 World 1.6B widths in llama.cpp's Q8_0 (every matrix Q8_0, the
    # head included)
    "v6q8": dict(make="make_v6_gguf", seed=50, quantize="Q8_0", head_quantize="Q8_0",
                 kinds=("qk_nomin", "qk_nomin"),
                 # 6 of the model's 24 layers: beside the other models, the slot
                 # stacks and the serving and file phases, the run stays within
                 # its time
                 widths=dict(n_layer=6, n_emb=2048, head_size=64, n_vocab=VOCAB, n_hidden=7168,
                             rank_tm=32, rank_td=64),
                 matrices=_V6_MATRICES, wkv=("wkv6_scan", "wkv6_scan", None),
                 mega=("mega56", "layer_scan56"), mega_batches=(4, 1, 16),
                 engine=dict(prefill_dense=False)),
    # RWKV-7 0.1B widths from an f16 file, requantized at load as the
    # reference's --quant int8 does (u8 codes per 128 with f16 bounds)
    "v7i8": dict(make="make_v7_gguf", seed=60, quantize=None, quant="INT8",
                 kinds=("int8", "dense"), grouped=True,
                 # 6 of the model's 12 layers, and the run stays within its time
                 widths=dict(n_layer=6, n_emb=768, head_size=64, n_vocab=VOCAB, n_hidden=3072,
                             lora_w=64, lora_a=64, lora_g=128, lora_v=32),
                 matrices=(("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wo"),
                           ("ffn", "Wk"), ("ffn", "Wv")),
                 wkv=("att_core7_step", "wkv7_scan", None), mega=("mega7", "layer_scan7"),
                 mega_batches=(4, 1, 16)),
    # the same widths requantized as --quant nf4 does (4-bit normal-quantile
    # codebook per 64 with an f16 absmax); no whole-stack form, as in the
    # JAX package. Its card-vs-CPU model is seed 72's: seed 71's reads past
    # the limits with the JAX package in the card's place, the order of the
    # LayerNorm's f32 sums alone moving it there (tests/
    # test_torch_requant_decode.py::test_nf4_compare_model_against_jax;
    # PERF.md, Findings)
    "v7nf4": dict(make="make_v7_gguf", seed=70, compare_seed=72, quantize=None, quant="NF4",
                  kinds=("nf4", "dense"),
                  # 6 of the model's 12 layers: its decode is the per-layer path,
                  # host-bound, and the run stays within its time
                  widths=dict(n_layer=6, n_emb=768, head_size=64, n_vocab=VOCAB,
                              n_hidden=3072, lora_w=64, lora_a=64, lora_g=128, lora_v=32),
                  matrices=(("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wo"),
                            ("ffn", "Wk"), ("ffn", "Wv")),
                  wkv=("att_core7_step", "wkv7_scan", None), mega=None, mega_batches=(),
                  snapshot=True, apps=("gen_nf4",)),
    # RWKV-6 World 1.6B widths requantized as --quant int8 does
    "v6i8": dict(make="make_v6_gguf", seed=80, quantize=None, quant="INT8",
                 kinds=("int8", "dense"),
                 # 6 of the model's 24 layers: the file is f16 (1.3 GB at this
                 # depth) and is quantized on the host at load, and the run
                 # stays within its time
                 widths=dict(n_layer=6, n_emb=2048, head_size=64, n_vocab=VOCAB, n_hidden=7168,
                             rank_tm=32, rank_td=64),
                 matrices=_V6_MATRICES, wkv=("wkv6_scan", "wkv6_scan", None),
                 mega=("mega56", "layer_scan56"), mega_batches=(4, 1, 16)),
    # RWKV-7 0.1B widths with every matrix in llama.cpp's Q6_K, the head
    # included: the native Q6_K slot of layer7.cu through the Engine, the
    # grouped r/k/v gemv on Q6_K's signed byte codes at B=1
    "v7q6": dict(make="make_v7_gguf", seed=90, quantize="Q6_K", head_quantize="Q6_K",
                 # 6 of the model's 12 layers, and the run stays within its time
                 kinds=("qk_nomin", "qk_nomin"), grouped=True, widths={**_V7_WIDTHS, "n_layer": 6},
                 matrices=_V7_MATRICES, wkv=("att_core7_step", "wkv7_scan", None),
                 mega=("mega7", "layer_scan7"), mega_batches=(4, 1, 16)),
    # RWKV-7 0.1B widths from an f16 file loaded as it is (no quant=): every
    # matrix dense bf16, the head included; the dense slot of layer7.cu
    # through the Engine; no grouped kind
    "v7f16": dict(make="make_v7_gguf", seed=100, quantize=None, kinds=("dense", "dense"),
                  # 6 of the model's 12 layers, and the run stays within its time
                  widths={**_V7_WIDTHS, "n_layer": 6}, matrices=_V7_MATRICES,
                  wkv=("att_core7_step", "wkv7_scan", None), mega=("mega7", "layer_scan7"),
                  mega_batches=(4, 1, 16), safetensors=True, lora=True),
}
PROMPTS = ([11, 2041, 7, 65000, 310, 42, 9, 1234], [5, 5, 60000, 88, 901, 3, 77, 12])
DECODE_STEPS = 32
COMPARE_LAYERS = 2  # depth of the card-vs-CPU comparison
# its decode steps at B=3: (token per lane, length per lane)
COMPARE_STEPS = [([11, 400, 65535], [1, 1, 1]), ([2041, 9, 3], [1, 1, 0]),
                 ([7, 60000, 5], [1, 1, 1])]
# the Engine phase: four prompts (lengths 300, 77, 40, 9, token ids from
# ENGINE_SEED), 32 greedy tokens each, then one infer with a FULL lane
ENGINE_LENGTHS = (300, 77, 40, 9)
ENGINE_SEED = 7
ENGINE_TOKENS = 32
ENGINE_CHUNK = 128  # token_chunk_size
# the infer call: (tokens, option) per lane; lane 0 asks for every row
FULL_LANES = ((60, "full"), (3, "last"), (0, "last"), (1, "last"))
# card-vs-CPU prefill: (T, lengths per lane) of two chunks at B=3
COMPARE_PREFILL = [(37, (37, 20, 0)), (128, (128, 90, 128))]
COMPARE_SEED = 2  # its prefill tokens
# the dense weights against the quantized ones (the Engine's prefill copy, and
# decode at B=16), × max|logit|: bf16-rounded weights against the kernels'
# classes, as the CPU tests hold them against the JAX package; or twice the
# quantized path's own distance from the f32-weight function where that is
# larger (RWKV-6 at the 1.6B widths: the quantized prefill sits 3.8e-2 from
# it on the CPU at two layers; PERF.md, Findings)
DENSE_TOL = 3e-2
# the pool: 32 lanes (two engines of 16), prompts of 8-47 tokens from
# POOL_SEED, one 32-token segment
POOL_LANES = 32
POOL_TOKENS = 33
POOL_SEED = 9
STATE_TOKENS = (17, 4000, 65535)  # a lane's tokens after its state file is loaded
HOOK_STEPS = 16  # decode steps of the hooked Engine
VISION_SEED = 9  # its patches [16, 16, 3, 64]: 16·16·3 = 768 = C, one T=64 chunk
LORA_RANK = 32
LORA_SEED = 12
LORA_ALPHA = 0.5  # matrices gain α/rank·B@A
LORA_VECTOR = ("blocks.1.att.x_k", 0.6)  # the one blended vector and its α
EMBED_TOKENS = 40  # the embeds phase's lanes: this many tokens each


def _app_hooks(name):
    def make(num_layer):
        from importlib import import_module

        return getattr(import_module(f"web_rwkv_gguf_tpu_torch.apps.{name}"),
                       f"make_{name}_hooks")(num_layer)

    return make


# the example apps' modifying hooks, by app: othello's two RWKV-7 taps (a ← 2a
# after the adapters, a ← act_w(w)·a after control-k) and puzzle15's RWKV-6
# tap (k ← exp(min(w, 0))·k before the decay's activation); each takes the
# model's layer count
HOOK_EXAMPLES = {name: _app_hooks(name) for name in ("othello", "puzzle15")}
# taps that fire once a forward (or head), at layer -1
MODEL_TAPS = {"post_embed_loaded", "post_embed_layer_norm", "pre_head", "post_head_layer_norm",
              "post_head"}


def lora_tensors(reader, n_layer, matrices, seed):
    """A rank-LORA_RANK LoRA of every layer matrix (``matrices``: model
    names after ``blocks.{i}.``) of ``n_layer`` layers of ``reader``'s
    model, (A, B) from ``seed``, and the LORA_VECTOR."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_layer):
        for m in matrices:
            name = f"blocks.{i}.{m}"
            rows, cols = reader.shape(name)
            out[f"{name}.lora.0"] = (rng.normal(size=(LORA_RANK, cols)) * 0.02).astype(np.float32)
            out[f"{name}.lora.1"] = (rng.normal(size=(rows, LORA_RANK)) * 0.02).astype(np.float32)
    vec, _ = LORA_VECTOR
    out[vec] = rng.normal(size=int(np.prod(reader.shape(vec)))).astype(np.float32)
    return out


LORA_MATRICES = ("att.key.weight", "att.value.weight", "att.receptance.weight",
                 "att.output.weight", "ffn.key.weight", "ffn.value.weight")

# The apps phase (a model's "apps" parts), through each app's main() on the
# model's file and a byte-level vocabulary of VOCAB entries (256 bytes, then
# "<tokN>"), so every prompt byte is one token: gen per token and fused
# (APP_TOKENS greedy tokens after the APP_PROMPT), batch fused on its four
# default prompts, chat scripted (CHAT_LINES: a turn, retry, reset, a turn),
# ppl over PPL_TOKENS tokens of text from PPL_SEED in chunks of PPL_CHUNK
# (and --compare-f16 over its first chunk), serde and gen from the snapshot,
# inspect, othello / puzzle15 (GAME_TOKENS), gen under utils.trace.trace_to,
# the native library's load against numpy's, and convert: a BlinkDL-layout
# RWKV-7 checkpoint at the 0.1B widths and CONVERT_LAYERS layers from
# CONVERT_SEED, written by torch.save and converted to q8_0 in a worker
# process, then one Engine step on it
APP_PROMPT = "The city"
APP_TOKENS = 32
CHAT_LINES = ("Hello there", "+", "-", "Hi")
CHAT_TOKENS = 16
PPL_TOKENS = 1024
PPL_CHUNK = 256
PPL_SEED = 13
PPL_TOL = 1e-2  # the nll, card against CPU on the two-layer model, relative
GAME_TOKENS = 8
CONVERT_SEED = 14
CONVERT_LAYERS = 2


def byte_vocab(n):
    """A byte-level vocabulary of ``n`` entries in the tokenizer's JSON form."""
    vocab = {str(i): [i] for i in range(256)}
    vocab.update({str(i): f"<tok{i}>" for i in range(256, n)})
    return vocab


def ppl_text():
    """PPL_TOKENS + 1 printable ASCII characters from PPL_SEED (one token each)."""
    import numpy as np

    return bytes(np.random.default_rng(PPL_SEED).integers(32, 127, PPL_TOKENS + 1)
                 .astype(np.uint8)).decode()


def v7_checkpoint(seed, n_layer):
    """A BlinkDL-layout RWKV-7 state dict at the 0.1B widths (torch tensors,
    the LoRA pairs as x @ w1: [in, out]) with weights from ``seed``."""
    import numpy as np
    import torch

    w = _V7_WIDTHS
    C, head_size, V, hidden = w["n_emb"], w["head_size"], w["n_vocab"], w["n_hidden"]
    rw, ra, rg, rv = w["lora_w"], w["lora_a"], w["lora_g"], w["lora_v"]
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.3):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    sd = {"emb.weight": t(V, C), "blocks.0.ln0.weight": 1 + t(C, scale=0.05),
          "blocks.0.ln0.bias": t(C, scale=0.05), "ln_out.weight": 1 + t(C, scale=0.05),
          "ln_out.bias": t(C, scale=0.05), "head.weight": t(V, C, scale=0.05)}
    for i in range(n_layer):
        p = f"blocks.{i}."
        sd.update({p + "ln1.weight": 1 + t(C, scale=0.05), p + "ln1.bias": t(C, scale=0.05),
                   p + "ln2.weight": 1 + t(C, scale=0.05), p + "ln2.bias": t(C, scale=0.05),
                   **{p + f"att.x_{m}": t(1, 1, C) for m in "rwkvag"},
                   p + "att.w0": t(1, 1, C), p + "att.w1": t(C, rw, scale=0.05),
                   p + "att.w2": t(rw, C, scale=0.05), p + "att.a0": t(1, 1, C),
                   p + "att.a1": t(C, ra, scale=0.05), p + "att.a2": t(ra, C, scale=0.05),
                   p + "att.g1": t(C, rg, scale=0.05), p + "att.g2": t(rg, C, scale=0.05),
                   p + "att.k_k": t(1, 1, C), p + "att.k_a": t(1, 1, C),
                   p + "att.r_k": t(C // head_size, head_size),
                   **{p + f"att.{m}.weight": t(C, C, scale=0.05)
                      for m in ("key", "value", "receptance", "output")},
                   p + "att.ln_x.weight": 1 + t(C, scale=0.05),
                   p + "att.ln_x.bias": t(C, scale=0.05), p + "ffn.x_k": t(1, 1, C),
                   p + "ffn.key.weight": t(hidden, C, scale=0.05),
                   p + "ffn.value.weight": t(C, hidden, scale=0.05)})
        if i > 0:
            sd.update({p + "att.v0": t(1, 1, C), p + "att.v1": t(C, rv, scale=0.05),
                       p + "att.v2": t(rv, C, scale=0.05)})
    return sd


def convert_checkpoint():
    """The convert app on a checkpoint from CONVERT_SEED (torch.save to a
    .pth, then ``apps.convert.main`` to q8_0), in a worker process: the
    output file's bytes, the app's seconds and its printed lines."""
    import torch

    from web_rwkv_gguf_tpu_torch.apps import convert

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(v7_checkpoint(CONVERT_SEED, CONVERT_LAYERS), f"{tmp}/model.pth")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            convert.main([f"{tmp}/model.pth", "--output", f"{tmp}/model.gguf",
                          "--outtype", "q8_0"])
        seconds = time.perf_counter() - t0
        with open(f"{tmp}/model.gguf", "rb") as f:
            return f.read(), seconds, out.getvalue().splitlines()

# peaks of the card from NVIDIA's data sheets (dense): HBM bytes/s,
# bf16 tensor-core FLOP/s, f32 (non-tensor) FLOP/s
PEAKS = {
    "PCIe": (2.0e12, 756e12, 51e12),
    "NVL": (3.9e12, 835e12, 60e12),
    "SXM": (3.35e12, 989e12, 67e12),
}
GEMV_TOL = 1e-4  # × max|plain|: the same f32 terms summed in another order
GEMM_TOL = 1e-4  # × max|plain|: the same bf16 products summed in another order
ATT_TOL = 1e-4  # absolute, on y of the active lanes and on the state
WKV_TOL = 1e-4  # × max|plain| over y and the state: f32 sums in another order
# × max|CPU| per array (the WKV state per layer, × that layer's max),
# card vs CPU at L=2. The kernels and cuBLAS sum in another order than
# the CPU, and the matmuls round their operands to bf16: a last-bit
# difference upstream can flip one operand's rounding by 2^-8, which
# moves this random-weight model's logits by up to 1.4e-3 of their max
# (seen on the CPU alone between a lane run at B=3 and the same lane at
# B=1). 1e-2 is ~2.5 bf16 steps. It holds the logits, both shift states
# and layer 0's WKV state. The RWKV-6 model at the 1.6B widths sits
# closest to it: there a one-ulp change can flip bf16 roundings of the
# squared-ReLU key in layer 0's FFN, which moves layer 1's att_shift by
# 2e-3 of its max on the CPU alone; the run measures this for its decode
# steps and its prefill (sensitivity(), printed beside the check; PERF.md,
# Findings).
CARD_CPU_TOL = 1e-2
# × that layer's max, for the WKV state of layers after the first: it
# sums k·vᵀ over every token of a prefill chunk, so each bf16 operand that
# a flip in layer 0 changes stays in it, on every token. This run
# measures that sensitivity itself (sensitivity(), printed beside the
# check): one-ulp changes of every matmul product move layer 1's WKV
# state by up to 6.7e-3 of its max on the card alone, and the card sits
# 1.7e-2 from the CPU there (both deterministic; PERF.md, Findings).
CARD_CPU_WKV_TOL = 3e-2
# RWKV-4's state (aa, bb, pp) is held, at the same limits, as what its
# output depends on: y = σ(r)·(aa/bb + e^{u+k-z}·v) / (1 + e^{u+k-z})
# with z = pp + ln bb, so the past's weighted mean of v, aa/bb, and the
# log of its total weight, z (and pp itself, absolutely over the entries
# off the F32_MIN sentinel). aa and bb alone are not held: they weigh each
# past token by e^{k-pp}, so a shift δ of the leading token's k (|k| up to
# ~50 on these random weights) moves both by about δ of their size while
# aa/bb and z barely move (PERF.md, Findings).
V4_VIEWS = ("aa/bb", "pp", "pp+ln bb")
# one-ulp product changes: noise seeds on the card and on the CPU
SENSITIVITY_SEEDS = {"cuda": (0, 1, 2, 3), "cpu": (0, 1)}
# the whole-stack decode kernel against its plain version, × max|plain|
# per array, layer by layer on the same inputs (each layer launched as a
# one-layer slice fed from the plain version's chain): one layer's f32
# sums in another order flip a few of the bf16 roundings of its matmul
# inputs, each by one bf16 step (2^-8); a layer must stay within one such
# step of its largest value (seen: up to 1.0e-3; PERF.md, Findings). An
# RWKV-7 layer's LayerNorm outputs (its new shift states) are held so against
# the plain version's, and its x, WKV state and v_first against the plain
# version given the kernel's LayerNorm outputs (``layer_scan7_plain(...,
# ln_out=)``): the kernel, PyTorch on the card and the CPU each sum a
# LayerNorm in their own order, and where one of the six mixes' bf16
# roundings sits on a tie that order alone moves the layer's WKV state past
# one step, the kernel equal to one of the two plain versions and not the
# other (scripts/torch_trace_lane.py; PERF.md, Findings).
MEGA_LAYER_TOL = 2.0 ** -8
# For versions 6 and 5 a layer's x may pass instead through what it is made
# of, in at most MEGA_FLIP_LAYERS layers of a case and with x within
# MEGA_FLIP_X·MEGA_LAYER_TOL of its max: x replayed from the kernel's staged
# operands (MEGA_REPLAY_TOL), its f32 products r/k/v/g and FFN receptance
# within MEGA_LAYER_TOL of the plain version's max, and every element of
# its bf16 operands at most one bf16 step from their replay from its own
# earlier ones (y from r/k/v/g, khid from y; below MEGA_LAYER_TOL of their
# max in steps of that floor): staged_excess. Flips of the mixes' bf16
# roundings move r and k, then y, then the FFN's bf16 inputs, which change
# thousands of its relu² roundings at once, and their sum through the
# 7,168-wide FFN value can move x past one step of its max (RWKV-6 Q8_0,
# 1.6B widths, layer 0 at B=4: 4,007 of 28,672 khid elements, x at 1.83 of
# the limit, khid up to 14,994 of its own bf16 steps from the plain
# version's near 0 but not from its replay; PERF.md, Findings PR 5)
MEGA_FLIP_LAYERS = 2
MEGA_FLIP_X = 4.0
# × max|x|: a layer's x from the whole-stack kernel (versions 6 to 4)
# against the same layer replayed in plain PyTorch on the kernel's own
# staged operands (its bf16 inputs to Wo and the FFN value, its f32 FFN
# receptance), where only the order of f32 sums differs
MEGA_REPLAY_TOL = 1e-4
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
    if "check" in case:  # a comparison of its own
        err, limit = case["check"](args)
    else:
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
    library_ms = None
    if "library" in case:  # one PyTorch call on the same inputs, in a graph
        lib_sets = [case["library_args"](a) for a in sets]
        library_ms = time_graph(torch, [lambda a=a: case["library"](*a) for a in lib_sets])
        del lib_sets
    bytes_ms = case["nbytes"] / hbm * 1e3
    ops_ms = case["flops"] / case["fpeak"] * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    bound_ms = max(bytes_ms, ops_ms)
    lib = ("none" if library_ms is None
           else f"{library_ms * 1e3:.4f} us (kernel / library {ms / library_ms:.3f})")
    log(f"  {name}: {case['nbytes'] / 1e6:.4f} MB, {case['flops'] / 1e9:.4f} GFLOP, "
        f"bound {bound_ms * 1e3:.4f} us ({bound_by}), kernel {ms * 1e3:.4f} us in a "
        f"graph, {eager_ms * 1e3:.4f} us issued eagerly, plain {plain_ms * 1e3:.4f} us, "
        f"library {lib}, {copies} input copies")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _rng(torch, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ints = lambda lo, hi, s, dt: torch.randint(  # noqa: E731
        lo, hi, s, generator=g, device=dev, dtype=dt)
    floats = lambda *s: torch.rand(*s, generator=g, device=dev)  # noqa: E731
    normal = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    return ints, floats, normal


def gemv_compare(got, want):
    return (got - want).abs().max().item(), GEMV_TOL * want.abs().max().item()


def q4k_case(torch, mm, op, m, k, n, seed, bf16_peak, dev="cuda", relu2=False):
    """``op`` ("gemv" or "gemm") of the Q4_K kernels at [m, k] with n rows.
    The library yardstick (both ops): torch.matmul of the bf16 x against
    the weight dequantized to bf16 ahead of time (bf16(q·s), without the
    offset term). ``relu2``: x = relu(z)², all ≥ 0, as the FFN value's
    input."""
    def make(i):
        ints, floats, normal = _rng(torch, dev, seed + 1000 * i)
        x = normal(n, k)
        x = torch.relu(x) ** 2 if relu2 else x
        return (x.to(torch.bfloat16), ints(0, 256, (m, k // 2), torch.uint8),
                ints(0, 64, (m, k // 32), torch.uint8), ints(0, 64, (m, k // 32), torch.uint8),
                floats(m, k // 256) * 1e-2, floats(m, k // 256) * 1e-2)

    def q4k_w(args):
        x, codes, sc6, mn6, d8, dm8 = args
        s, _ = mm.q4k_scale_products(sc6, mn6, d8, dm8)
        q = mm.q4k_codes(codes)
        return x, (q.view(m, k // 32, 32) * s[..., None]).view(m, k).to(torch.bfloat16).T

    tag = "relu2," if relu2 else ""
    case = dict(name=f"q4k_{op}[{tag}m={m},k={k},n={n}]", kernel=getattr(mm, f"q4k_{op}"),
                shape=(n, m, k), plain=getattr(mm, f"q4k_{op}_plain"), make_args=make,
                compare=gemv_compare if op == "gemv" else gemm_compare,
                nbytes=m * k // 2 + 2 * m * k // 32 + 8 * m * k // 256 + 2 * n * k + 4 * n * m,
                flops=2 * n * m * k, fpeak=bf16_peak, library=torch.matmul,
                library_args=q4k_w)
    return case


def q6k_case(torch, mm, op, m, k, n, seed, bf16_peak, dev="cuda", kind="Q6_K"):
    """``op`` of the Q6_K kernels (the head) at [m, k] with n rows; the
    library yardstick as for Q4_K, on the whole dequantized weight. ``kind``
    "Q3_K": Q3_K's code and scale-code ranges, on the same kernels."""
    q, sc = (32, 128) if kind == "Q6_K" else (4, 32)

    def make(i):
        ints, floats, normal = _rng(torch, dev, seed + 1000 * i)
        return (normal(n, k).to(torch.bfloat16), ints(-q, q, (m, k), torch.int8),
                ints(-sc, sc, (m, k // 16), torch.int8), floats(m, k // 256) * 1e-3)

    tag = "" if kind == "Q6_K" else f"{kind},"
    case = dict(name=f"q6k_{op}[{tag}m={m},k={k},n={n}]", kernel=getattr(mm, f"q6k_{op}"),
                shape=(n, m, k), plain=getattr(mm, f"q6k_{op}_plain"), make_args=make,
                compare=gemv_compare if op == "gemv" else gemm_compare,
                nbytes=m * k + m * k // 16 + 4 * m * k // 256 + 2 * n * k + 4 * n * m,
                flops=2 * n * m * k, fpeak=bf16_peak, library=torch.matmul,
                library_args=lambda a: (a[0], mm.q6k_dequantize(*a[1:]).to(torch.bfloat16).T))
    return case


# the forms of the Q5_K/Q2_K and f32-scale kernels by block type: kernel
# family, group size, code storage ("nib": split-halves nibbles, "u8", "i8")
# and the codes' bound (u8 in [0, bound), i8 in [-bound, bound)), offsets
FORMS = {"Q5_K": ("qkb", 32, "u8", 32, True), "Q2_K": ("qkb", 16, "u8", 4, True),
         "Q8_0": ("qs", 32, "i8", 128, False), "Q4_0/Q4_1": ("qs", 32, "nib", 16, True),
         "Q5_0/Q5_1": ("qs", 32, "u8", 32, True), "Q4_K": ("qs", 32, "nib", 16, True)}


def form_case(torch, mm, kind, op, m, k, n, seed, bf16_peak, dev="cuda"):
    """``op`` of the kernels of ``kind``'s form (FORMS) at [m, k] with n
    rows on random codes and factors; the library yardstick as for Q4_K:
    torch.matmul of the bf16 x against bf16(q·s), without the offsets."""
    family, gs, store, bound, offsets = FORMS[kind]
    g = k // gs

    def make(i):
        ints, floats, normal = _rng(torch, dev, seed + 1000 * i)
        x = normal(n, k).to(torch.bfloat16)
        if store == "nib":
            codes = ints(0, 256, (m, k // 2), torch.uint8)
        elif store == "u8":
            codes = ints(0, bound, (m, k), torch.uint8)
        else:
            codes = ints(-bound, bound, (m, k), torch.int8)
        if family == "qkb":
            return (x, codes, ints(0, 64, (m, g), torch.uint8), ints(0, 64, (m, g), torch.uint8),
                    floats(m, k // 256) * 1e-2, floats(m, k // 256) * 1e-2)
        return (x, codes, floats(m, g) * 1e-2, floats(m, g) * 1e-1 if offsets else None)

    def weight(args):
        x, codes, *factors = args
        if family == "qkb":
            s, _ = mm.q4k_scale_products(*factors)
        else:
            s = factors[0]
        q = mm.qs_codes(codes, k)
        return x, (q.view(m, g, gs) * s[..., None]).view(m, k).to(torch.bfloat16).T

    code_bytes = m * k // 2 if store == "nib" else m * k
    factor_bytes = 2 * m * g + 8 * m * k // 256 if family == "qkb" else (8 if offsets else 4) * m * g
    return dict(name=f"{family}_{op}[{kind},m={m},k={k},n={n}]",
                kernel=getattr(mm, f"{family}_{op}"), shape=(n, m, k),
                plain=getattr(mm, f"{family}_{op}_plain"), make_args=make,
                compare=gemv_compare if op == "gemv" else gemm_compare,
                nbytes=code_bytes + factor_bytes + 2 * n * k + 4 * n * m,
                flops=2 * n * m * k, fpeak=bf16_peak, library=torch.matmul,
                library_args=weight)


def kernel_cases(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-7 main paths' kernel calls at their shapes (0.1B widths):
    Q4_K gemv at the layer shapes (n = 1, 4 and 8), the Q6_K head gemv
    (n = 1 and 4), the attention core at B=1, at B=3 with a masked lane,
    at B=4 and at B=16 (H=12, hs=64); the Q4_K dequant-GEMM at the layer shapes
    (n = 4: decode at B=4; 128 and 512: prefill chunks; 256: the ppl app's
    chunks), the Q6_K head GEMM at the FULL call's ``full_rows`` and at
    n = 256 (a ppl chunk's rows), and the WKV scan at T=64 for
    B=1 and 4 with ragged lengths and at T=8 for B=1 (the serve's prompt
    chunks). ``k``: the kernel modules by name."""
    dev = torch.device(dev)
    mm, core = k["matmul"], k["wkv7"]
    layer_shapes = ((768, 768), (3072, 768), (768, 3072))
    cases = [q4k_case(torch, mm, "gemv", m, k, n, m + 7 * k + n, bf16_peak)
             for m, k in layer_shapes for n in (1, 4, 8)]
    cases += [q6k_case(torch, mm, "gemv", 65536, 768, n, 2000 + n, bf16_peak) for n in (1, 4)]

    H, K = 12, 64
    for B in (1, 3, 4, 16):
        lanes = {1: [True], 3: [True, False, True], 4: [True] * 4, 16: [True] * 16}[B]
        active = [b for b in range(B) if lanes[b]]  # lanes the mask keeps running

        def make_att(i, B=B, lanes=lanes):
            _, _, normal = _rng(torch, dev, 3000 * i + B)
            f = lambda *s: normal(*s) * 0.5  # noqa: E731
            mask = torch.tensor(lanes, device=dev)
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
            # state in and out; r, w, k, a, v, g in and y out; 5 params; the
            # mask, a byte a lane
            nbytes=4 * (2 * B * H * K * K + 7 * B * H * K + 5 * H * K) + B,
            flops=8 * B * H * K * K, fpeak=f32_peak))

    cases += [q4k_case(torch, mm, "gemm", m, k, n, 4000 + m + 7 * k + n, bf16_peak)
              for m, k in layer_shapes for n in (4, 128, 256, 512)]
    cases += [q6k_case(torch, mm, "gemm", 65536, 768, n, seed, bf16_peak)
              for n, seed in ((full_rows, 5001), (PPL_CHUNK, 5002))]

    # (T, lengths, seed): a lane of an Engine chunk, B=4 ragged, the B=1
    # serve's 8-token prompt chunk, and the hooked Engine's decode step (T=1)
    for T, lens, seed in ((64, (50,), 1), (64, (64, 40, 17, 0), 4), (8, (8,), 108),
                          (1, (1, 1, 1, 1), 110)):
        B = len(lens)

        def make_scan(i, B=B, T=T, lens=lens, seed=seed):
            _, _, normal = _rng(torch, dev, 6000 * i + seed)
            f = lambda *s: normal(*s) * 0.5  # noqa: E731
            kk = torch.nn.functional.normalize(f(B, T, H, K), dim=-1)
            mask = (torch.arange(T, device=dev)[None, :]
                    < torch.tensor(lens, device=dev)[:, None])
            return (f(B, H, K, K), f(B, T, H, K),
                    torch.exp(-0.606531 * torch.sigmoid(f(B, T, H, K))), f(B, T, H, K),
                    f(B, T, H, K), -kk, kk * torch.sigmoid(f(B, T, H, K)), mask)

        live = sum(lens)
        cases.append(dict(
            name=f"wkv7_scan[B={B},T={T},H={H},hs={K},lens={list(lens)}]",
            kernel=core.wkv7_scan, shape=(B, T, H, K), plain=core.wkv7_scan_plain,
            make_args=make_scan, compare=scan_compare,
            # state in and out; r, w, k, v, a, b in and y out; the mask
            nbytes=4 * (2 * B * H * K * K + 7 * B * T * H * K) + B * T,
            # 8·K·V per live token (update and y), 2·K·V per padded one (y)
            flops=(8 * live + 2 * (B * T - live)) * H * K * K, fpeak=f32_peak))
    return cases


def kernel_cases6(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-6 main paths' kernel calls at the 1.6B widths (C=2048,
    hidden 7168, H=32): the Q4_K gemv at n = 1 (the B=1 serve's decode;
    the FFN value also on relu² inputs), the Q4_K GEMM at n = 512 (an Engine chunk of T=128 at B=4), the Q6_K
    head gemv at n = 1 and GEMM at n = 4 (the Engine's decode step: at
    K=2048 the gate sends n ≥ 3 to the GEMM) and at the FULL call's
    ``full_rows``; the V6 WKV scan at T=64 for B=1 and 4 with ragged
    lengths, and at B=1 for T = 8 and 1 (the serve's prompt chunks and its
    per-layer decode)."""
    dev = torch.device(dev)
    mm, wkv6 = k["matmul"], k["wkv6"]
    layer_shapes = ((2048, 2048), (7168, 2048), (2048, 7168))
    cases = [q4k_case(torch, mm, "gemv", m, k, 1, 7000 + m + 7 * k, bf16_peak)
             for m, k in layer_shapes]
    # the FFN value's input is relu² (all ≥ 0): the offset term cancels most
    # of each group's products
    cases.append(q4k_case(torch, mm, "gemv", 2048, 7168, 1, 7050, bf16_peak, relu2=True))
    cases += [q4k_case(torch, mm, "gemm", m, k, 512, 7500 + m + 7 * k, bf16_peak)
              for m, k in layer_shapes]
    cases.append(q6k_case(torch, mm, "gemv", 65536, 2048, 1, 8001, bf16_peak))
    cases += [q6k_case(torch, mm, "gemm", 65536, 2048, n, 8100 + n, bf16_peak)
              for n in (4, full_rows)]

    H, K = 32, 64
    # (T, lengths, seed): a lane of an Engine chunk, B=4 ragged, the B=1
    # serve's 8-token prompt chunk and its per-layer decode token
    for T, lens, seed in ((64, (50,), 1), (64, (64, 40, 17, 0), 4), (8, (8,), 108),
                          (1, (1,), 101)):
        B = len(lens)

        def make_scan(i, B=B, T=T, lens=lens, seed=seed):
            _, _, normal = _rng(torch, dev, 9000 * i + seed)
            f = lambda *s: normal(*s) * 0.5  # noqa: E731
            mask = (torch.arange(T, device=dev)[None, :]
                    < torch.tensor(lens, device=dev)[:, None])
            return (f(B, H, K, K), f(B, T, H, K), f(B, T, H, K), f(B, T, H, K), f(H, K),
                    torch.exp(-torch.exp(f(B, T, H, K))), mask)

        live = sum(lens)
        cases.append(dict(
            name=f"wkv6_scan[B={B},T={T},H={H},hs={K},lens={list(lens)}]",
            kernel=wkv6.wkv6_scan, shape=(B, T, H, K), plain=wkv6.wkv6_scan_plain,
            make_args=make_scan, compare=scan_compare,
            # state in and out; r, k, v, w in and y out; u; the mask
            nbytes=4 * (2 * B * H * K * K + 5 * B * T * H * K + H * K) + B * T,
            # 6·K·V per live token (update and y), 2·K·V per padded one (y)
            flops=(6 * live + 2 * (B * T - live)) * H * K * K, fpeak=f32_peak))
    return cases


def kernel_cases5(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-5 main paths' kernel shapes at the World 0.4B widths
    (C=1024, hidden 3584, H=16): the Q4_K gemv at n = 1 (the B=1 serve's
    decode) and 4, and at n = 8 at K=1024 (its prompt chunks), the Q4_K GEMM at n = 512 (an Engine chunk of T=128 at
    B=4), the Q6_K head gemv at n = 1 and 4 (at K=1024 the gate keeps n ≤
    4 on the gemv) and GEMM at the FULL call's ``full_rows``; the V6 WKV
    scan as the V5 path calls it (``forward._wkv5``: the static decay [H,
    K] expanded over [B, T, H, K]) at B=1 for T = 1 (the serve's decode)
    and 8 (its prompts), and at B=4, T=64 with ragged lengths (an Engine
    chunk)."""
    mm, wkv6 = k["matmul"], k["wkv6"]
    dev = torch.device(dev)
    layer_shapes = ((1024, 1024), (3584, 1024), (1024, 3584))
    cases = [q4k_case(torch, mm, "gemv", m, kk, n, 11000 + m + 7 * kk + n, bf16_peak, dev)
             for m, kk in layer_shapes for n in (1, 4)]
    # the B=1 serve's 8-token prompt chunks (n·groups ≤ 256 at K=1024)
    cases += [q4k_case(torch, mm, "gemv", m, kk, 8, 11000 + m + 7 * kk + 8, bf16_peak, dev)
              for m, kk in layer_shapes[:2]]
    cases += [q4k_case(torch, mm, "gemm", m, kk, 512, 11500 + m + 7 * kk, bf16_peak, dev)
              for m, kk in layer_shapes]
    cases += [q6k_case(torch, mm, "gemv", 65536, 1024, n, 12000 + n, bf16_peak, dev)
              for n in (1, 4)]
    cases.append(q6k_case(torch, mm, "gemm", 65536, 1024, full_rows, 12100, bf16_peak, dev))

    H, K = 16, 64
    for T, lens in ((1, (1,)), (8, (8,)), (64, (64, 40, 17, 0))):
        B = len(lens)

        def make_scan(i, B=B, T=T, lens=lens):
            _, _, normal = _rng(torch, dev, 14000 * i + B + T)
            f = lambda *s: normal(*s) * 0.5  # noqa: E731
            mask = (torch.arange(T, device=dev)[None, :]
                    < torch.tensor(lens, device=dev)[:, None])
            return (f(B, H, K, K), f(B, T, H, K), f(B, T, H, K), f(B, T, H, K), f(H, K),
                    torch.exp(-torch.exp(f(H, K))).expand(B, T, H, K), mask)

        live = sum(lens)
        cases.append(dict(
            name=f"wkv6_scan[B={B},T={T},H={H},hs={K},lens={list(lens)},w static]",
            kernel=wkv6.wkv6_scan, shape=(B, T, H, K), plain=wkv6.wkv6_scan_plain,
            make_args=make_scan, compare=scan_compare,
            # state in and out; r, k, v in and y out; the static w and u; the mask
            nbytes=4 * (2 * B * H * K * K + 4 * B * T * H * K + 2 * H * K) + B * T,
            flops=(6 * live + 2 * (B * T - live)) * H * K * K, fpeak=f32_peak))
    return cases


def kernel_cases4(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-4 main paths' new kernel: the V4 WKV scan at the World 0.1B
    width (C=768) at B=1, T=64; B=4, T=64 with lengths (64, 40, 17, 0);
    B=4, T=128; B=4, T=16 and T=32 (an Engine chunk of a short prompt);
    and the B=1 serve's decode step (T=1) and 8-token prompt chunk (its
    matrices have the RWKV-7 0.1B shapes, held in kernel_cases). Lane 0
    starts from the initial state (pp at F32_MIN), the others from a
    random one; in the serve's cases lane 0 carries a random state, as a
    decode step does."""
    from web_rwkv_gguf_tpu_torch.ops.wkv import F32_MIN

    wkv4 = k["wkv4"]
    dev = torch.device(dev)
    C = 768
    cases = []
    # (T, lengths, whether lane 0 starts from the initial state)
    for T, lens, fresh in ((64, (64,), True), (64, (64, 40, 17, 0), True),
                           (128, (128,) * 4, True), (16, (16, 16, 9, 0), True),
                           (32, (32, 32, 17, 0), True), (1, (1,), False), (8, (8,), False)):
        B = len(lens)

        def make_scan(i, B=B, T=T, lens=lens, fresh=fresh):
            _, _, normal = _rng(torch, dev, 13000 * i + B + T)
            f = lambda *s: normal(*s) * 0.5  # noqa: E731
            state = torch.stack([f(B, C), f(B, C).abs() + 0.1, f(B, C)], dim=-1)
            if fresh:
                state[0] = torch.tensor([0.0, 0.0, F32_MIN], device=dev)
            mask = (torch.arange(T, device=dev)[None, :]
                    < torch.tensor(lens, device=dev)[:, None])
            return (state, f(B, T, C), f(B, T, C), f(B, T, C), f(C), -torch.exp(f(C)), mask)

        def compare(got, want, lens=lens):
            (y1, s1), (y0, s0) = got, want
            mask = (torch.arange(y0.shape[1], device=dev)[None, :]
                    < torch.tensor(lens, device=dev)[:, None])
            sentinel = s0[..., 2] == F32_MIN
            if not torch.equal(s1[..., 2][sentinel], s0[..., 2][sentinel]):
                return math.inf, 0.0  # a lane left or lost the sentinel
            frozen = [b for b, n in enumerate(lens) if n == 0]
            if frozen and not torch.equal(s1[frozen], s0[frozen]):
                return math.inf, 0.0  # a lane of length 0 changed its state
            pp1, pp0 = s1[..., 2][~sentinel], s0[..., 2][~sentinel]
            err = max((y1[mask] - y0[mask]).abs().max().item(),
                      (s1[..., :2] - s0[..., :2]).abs().max().item(),
                      (pp1 - pp0).abs().max().item())
            return err, WKV_TOL * max(y0[mask].abs().max().item(),
                                      s0[..., :2].abs().max().item(), pp0.abs().max().item())

        live = sum(lens)
        cases.append(dict(
            name=f"wkv4_scan[B={B},T={T},C={C},lens={list(lens)}]", kernel=wkv4.wkv4_scan,
            shape=(B, T, C), plain=wkv4.wkv4_scan_plain, make_args=make_scan,
            compare=compare,
            # k, v, r in and y out; the state in and out; u, w; the mask
            nbytes=4 * (4 * B * T * C + 2 * 3 * B * C + 2 * C) + B * T,
            # ~25 flops per live (token, channel): the output and the update
            flops=25 * live * C, fpeak=f32_peak))
    return cases


def kernel_cases7q5(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-7 Q5_K_M main paths' new kernel calls at the 0.1B widths:
    the Q5_K gemv at the layer shapes the gate gives it (n = 1, the B=1
    serve's decode, and 4), the Q5_K GEMM at [768, 3072] for n = 1 and 4
    (its codes do not tile the gemv: the gate sends it to the GEMM at every
    n) and at every layer shape for n = 512 (an Engine chunk of T=128 at
    B=4); its Q6_K head has the RWKV-7 Q4_K_M model's cases. Then, at one
    layer shape each, the forms no driven model reaches: Q2_K (Q5_K's
    kernels in 16-groups), Q3_K (the Q6_K kernels' codes), the f32-scale
    nibbles with offsets of Q4_0/Q4_1, the bytes with offsets of Q5_0/Q5_1
    and Q4_K at K=384: the gemv at n = 1 and 4, the GEMM at n = 64."""
    mm = k["matmul"]
    cases = [form_case(torch, mm, "Q5_K", "gemv", m, kk, n, 15000 + m + 7 * kk + n, bf16_peak,
                       dev) for m, kk in ((768, 768), (3072, 768)) for n in (1, 4)]
    cases += [form_case(torch, mm, "Q5_K", "gemm", 768, 3072, n, 15100 + n, bf16_peak, dev)
              for n in (1, 4)]
    cases += [form_case(torch, mm, "Q5_K", "gemm", m, kk, 512, 15200 + m + 7 * kk, bf16_peak,
                        dev) for m, kk in ((768, 768), (3072, 768), (768, 3072))]
    for j, (kind, m, kk) in enumerate((("Q2_K", 768, 768), ("Q4_0/Q4_1", 768, 768),
                                       ("Q5_0/Q5_1", 768, 768), ("Q4_K", 768, 384))):
        cases += [form_case(torch, mm, kind, op, m, kk, n, 16000 + 100 * j + n, bf16_peak, dev)
                  for op, n in (("gemv", 1), ("gemv", 4), ("gemm", 64))]
    cases += [q6k_case(torch, mm, op, 768, 768, n, 16500 + n, bf16_peak, dev, kind="Q3_K")
              for op, n in (("gemv", 1), ("gemv", 4), ("gemm", 64))]
    return cases


def kernel_cases6q8(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-6 Q8_0 main paths' new kernel calls at the 1.6B widths:
    the f32-scale gemv at n = 1 (the B=1 serve's decode) at the shapes
    whose codes tile it, the f32-scale GEMM at [2048, 7168] for n = 1
    (the gate sends it there at every n) and at every layer shape for
    n = 512 (an Engine chunk of T=128 at B=4); the Q8_0 head's gemv at n
    = 1 and 4 (at K=2048 the gate keeps n ≤ 4 on the gemv) and GEMM at the
    FULL call's ``full_rows``."""
    mm = k["matmul"]
    cases = [form_case(torch, mm, "Q8_0", "gemv", m, kk, 1, 17000 + m + 7 * kk, bf16_peak, dev)
             for m, kk in ((2048, 2048), (7168, 2048))]
    cases.append(form_case(torch, mm, "Q8_0", "gemm", 2048, 7168, 1, 17100, bf16_peak, dev))
    cases += [form_case(torch, mm, "Q8_0", "gemm", m, kk, 512, 17200 + m + 7 * kk, bf16_peak,
                        dev) for m, kk in ((2048, 2048), (7168, 2048), (2048, 7168))]
    cases += [form_case(torch, mm, "Q8_0", "gemv", 65536, 2048, n, 17300 + n, bf16_peak, dev)
              for n in (1, 4)]
    cases.append(form_case(torch, mm, "Q8_0", "gemm", 65536, 2048, full_rows, 17400, bf16_peak,
                           dev))
    return cases


def requant_case(torch, mm, scheme, op, m, k, n, seed, bf16_peak, dev="cuda"):
    """``op`` of the kernels of an engine-requantized matrix at [m, k] with
    n rows, on random codes and block factors with f16 values: Int8
    through ``qs_*`` (u8 codes per 128; the gemv class's scales (mx −
    mn)/255, the GEMM's (mx − mn)·(1/255), offsets −mn, as
    ``models.matrix.int8_operands`` forms them), NF4 / SF4 through
    ``nf4_*`` with the scheme's codebook. The library yardstick:
    torch.matmul of the bf16 x against the bf16 weight."""
    from web_rwkv_gguf_tpu_torch.quant import formats

    int8 = scheme == "INT8"
    family = "qs" if int8 else "nf4"
    lut = None if int8 else formats.NF4_QUANTILES if scheme == "NF4" else formats.sf4_quantiles()

    def make(i):
        ints, floats, normal = _rng(torch, dev, seed + 1000 * i)
        x = normal(n, k).to(torch.bfloat16)
        if int8:
            mn = -(floats(m, k // 128) * 0.1 + 0.05).half().float()
            mx = (floats(m, k // 128) * 0.1 + 0.05).half().float()
            s = (mx - mn) * (1.0 / 255.0) if op == "gemm" else (mx - mn) / 255.0
            return x, ints(0, 256, (m, k), torch.uint8), s, -mn
        absmax = (floats(m, k // 64) * 0.1 + 0.01).half().float()
        return (x, ints(0, 256, (m, k // 2), torch.uint8), absmax,
                torch.tensor(lut, device=dev))

    def weight(args):
        x, codes, a, b = args
        w = mm.qs_dequantize(codes, a, b) if int8 else mm.nf4_dequantize(codes, a, b)
        return x, w.to(torch.bfloat16).T

    weight_bytes = m * k + 8 * m * (k // 128) if int8 else m * k // 2 + 4 * m * (k // 64) + 64
    return dict(name=f"{family}_{op}[{scheme},m={m},k={k},n={n}]",
                kernel=getattr(mm, f"{family}_{op}"), shape=(n, m, k),
                plain=getattr(mm, f"{family}_{op}_plain"), make_args=make,
                compare=gemv_compare if op == "gemv" else gemm_compare,
                nbytes=weight_bytes + 2 * n * k + 4 * n * m, flops=2 * n * m * k,
                fpeak=bf16_peak, library=torch.matmul, library_args=weight)


def kernel_cases7i8(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-7 Int8 main paths' new kernel calls at the 0.1B widths: the
    Int8 form of the f32-scale gemv at the shapes whose codes tile it (n =
    1, the B=1 serve's decode, and 4), its GEMM at [768, 3072] for n = 1
    and 4 (the gate sends it there at every n) and at every layer shape
    for n = 512 (an Engine chunk of T=128 at B=4); the head is dense
    (torch.matmul)."""
    mm = k["matmul"]
    cases = [requant_case(torch, mm, "INT8", "gemv", m, kk, n, 18000 + m + 7 * kk + n,
                          bf16_peak, dev) for m, kk in ((768, 768), (3072, 768)) for n in (1, 4)]
    cases += [requant_case(torch, mm, "INT8", "gemm", 768, 3072, n, 18100 + n, bf16_peak, dev)
              for n in (1, 4)]
    cases += [requant_case(torch, mm, "INT8", "gemm", m, kk, 512, 18200 + m + 7 * kk,
                           bf16_peak, dev) for m, kk in ((768, 768), (3072, 768), (768, 3072))]
    return cases


def kernel_cases7nf4(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-7 NF4 main paths' new kernel calls at the 0.1B widths: the
    NF4 gemv at every layer shape for n = 1 (the B=1 serve's decode) and
    at the K=768 shapes for n = 4 (the Engine's per-layer decode step at
    B=4), the NF4 GEMM at [768, 3072] for n = 4 (its 96 groups a row send
    it past the gate) and at every layer shape for n = 512 (an Engine
    chunk of T=128 at B=4); the same kernels with the SF4 codebook."""
    mm = k["matmul"]
    layer_shapes = ((768, 768), (3072, 768), (768, 3072))
    cases = [requant_case(torch, mm, "NF4", "gemv", m, kk, 1, 19000 + m + 7 * kk, bf16_peak, dev)
             for m, kk in layer_shapes]
    cases += [requant_case(torch, mm, "NF4", "gemv", m, kk, 4, 19100 + m + 7 * kk, bf16_peak,
                           dev) for m, kk in layer_shapes[:2]]
    cases.append(requant_case(torch, mm, "NF4", "gemm", 768, 3072, 4, 19200, bf16_peak, dev))
    cases += [requant_case(torch, mm, "NF4", "gemm", m, kk, 512, 19300 + m + 7 * kk, bf16_peak,
                           dev) for m, kk in layer_shapes]
    cases += [requant_case(torch, mm, "SF4", op, m, kk, n, 19400 + n, bf16_peak, dev)
              for op, m, kk, n in (("gemv", 768, 768, 1), ("gemm", 768, 3072, 512))]
    return cases


def kernel_cases6i8(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-6 Int8 main paths' new kernel calls at the 1.6B widths: the
    Int8 gemv at n = 1 (the B=1 serve's decode) at the shapes whose codes
    tile it, its GEMM at [2048, 7168] for n = 1 (the gate sends it there at
    every n) and at every layer shape for n = 512 (an Engine chunk of
    T=128 at B=4); the head is dense (torch.matmul)."""
    mm = k["matmul"]
    cases = [requant_case(torch, mm, "INT8", "gemv", m, kk, 1, 20000 + m + 7 * kk, bf16_peak, dev)
             for m, kk in ((2048, 2048), (7168, 2048))]
    cases.append(requant_case(torch, mm, "INT8", "gemm", 2048, 7168, 1, 20100, bf16_peak, dev))
    cases += [requant_case(torch, mm, "INT8", "gemm", m, kk, 512, 20200 + m + 7 * kk, bf16_peak,
                           dev) for m, kk in ((2048, 2048), (7168, 2048), (2048, 7168))]
    return cases


# the matrix kind of each block type the grouped gemv takes
GROUPED_KINDS = {"Q4_K": "qk", "Q4_0": "qk", "Q5_K": "qk_b", "Q6_K": "qk_nomin",
                 "Q8_0": "qk_nomin", "Int8": "int8"}


def grouped_case(torch, mm, kind, m, k, n, seed, bf16_peak, dev="cuda"):
    """``quant_gemv_grouped`` on three [m, k] matrices of block type
    ``kind`` (GROUPED_KINDS) with random codes and factors, n rows each,
    grouped by ``models.group_gemv_matrices``. The library yardstick: one
    torch.bmm of the bf16 inputs [3, n, k] against the three weights
    dequantized to bf16 ahead of time."""
    from web_rwkv_gguf_tpu_torch.models import Matrix, group_gemv_matrices

    mkind = GROUPED_KINDS[kind]
    u8, i8 = torch.uint8, torch.int8

    def matrix(ints, floats):
        if kind in ("Q4_K", "Q5_K"):
            codes = (ints(0, 256, (m, k // 2), u8) if kind == "Q4_K"
                     else ints(0, 32, (m, k), u8))
            a = {"codes": codes, "sc6": ints(0, 64, (m, k // 32), u8),
                 "mn6": ints(0, 64, (m, k // 32), u8), "d8": floats(m, k // 256) * 1e-2,
                 "dm8": floats(m, k // 256) * 1e-2}
        elif kind == "Q4_0":
            s = floats(m, k // 32) * 1e-2
            a = {"codes": ints(0, 256, (m, k // 2), u8), "scales": s, "mins": 8.0 * s}
        elif kind == "Q6_K":
            a = {"codes": ints(-32, 32, (m, k), i8), "q6s": ints(-128, 128, (m, k // 16), i8),
                 "q6d": floats(m, k // 256) * 1e-3}
        elif kind == "Q8_0":
            a = {"codes": ints(-128, 128, (m, k), i8), "scales": floats(m, k // 32) * 1e-2}
        else:
            a = {"codes": ints(0, 256, (m, k), u8),
                 "mn": -(floats(m, k // 128) * 0.1 + 0.05).half().float(),
                 "mx": (floats(m, k // 128) * 0.1 + 0.05).half().float()}
        return Matrix(mkind, (m, k), a)

    def make(i):
        ints, floats, normal = _rng(torch, dev, seed + 1000 * i)
        grouped = group_gemv_matrices([matrix(ints, floats) for _ in range(3)])
        if grouped is None:
            raise AssertionError(f"{kind} [{m}, {k}] does not group")
        return normal(3, n, k).to(torch.bfloat16), mkind, grouped, m, k

    def weights(args):
        xs, _, g, _, _ = args
        off = g["offsets"]
        w = torch.stack([mm.qs_dequantize(c, g["scales"][i], None if off is None else off[i],
                                          k=k) for i, c in enumerate(g["codes"])])
        return xs, w.to(torch.bfloat16).transpose(1, 2)

    G = k // (128 if kind == "Int8" else 16 if kind == "Q6_K" else 32)
    code_bytes = m * k // 2 if mkind == "qk" else m * k
    offsets = kind not in ("Q6_K", "Q8_0")
    return dict(name=f"quant_gemv_grouped[{kind},3x m={m},k={k},n={n}]",
                kernel=mm.quant_gemv_grouped, shape=(n, m, k),
                plain=mm.quant_gemv_grouped_plain, make_args=make, compare=gemv_compare,
                # each matrix's codes, f32 scale products (and offsets); x, y
                nbytes=3 * (code_bytes + (8 if offsets else 4) * m * G + 2 * n * k + 4 * n * m),
                flops=3 * 2 * n * m * k, fpeak=bf16_peak, library=torch.bmm,
                library_args=weights)


def kernel_cases7q6(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The grouped r/k/v gemv of the B=1 unrolled decode at the 0.1B widths
    (3 × [768, 768], n = 1) for each kind it takes, and Q4_K at the 1.5B
    widths (3 × [2048, 2048], where the JAX package still groups Q4_K);
    then the RWKV-7 Q6_K main paths' other new kernel calls at the 0.1B
    widths: the Q6_K gemv at the shapes whose codes tile it (n = 1, the
    B=1 serve's Wo and FFN key), the Q6_K GEMM at [768, 3072] for n = 1
    (the FFN value: its codes do not tile the gemv, so the gate sends it
    to the GEMM at every n) and at every layer shape for n = 512 (an
    Engine chunk of T=128 at B=4)."""
    mm = k["matmul"]
    cases = [grouped_case(torch, mm, kind, 768, 768, 1, 21000 + 10 * j, bf16_peak, dev)
             for j, kind in enumerate(GROUPED_KINDS)]
    cases.append(grouped_case(torch, mm, "Q4_K", 2048, 2048, 1, 21100, bf16_peak, dev))
    layer_shapes = ((768, 768), (3072, 768), (768, 3072))
    cases += [q6k_case(torch, mm, "gemv", m, kk, 1, 21200 + m + 7 * kk, bf16_peak, dev)
              for m, kk in layer_shapes[:2]]
    cases.append(q6k_case(torch, mm, "gemm", 768, 3072, 1, 21250, bf16_peak, dev))
    cases += [q6k_case(torch, mm, "gemm", m, kk, 512, 21300 + m + 7 * kk, bf16_peak, dev)
              for m, kk in layer_shapes]
    return cases


def kernel_cases7f16(torch, k, bf16_peak, f32_peak, full_rows, dev="cuda"):
    """The RWKV-7 bf16 model's main paths call no kernel outside the
    whole-stack step that another model's cases do not hold: its matrices
    are dense (torch.matmul), and its attention core and WKV scan have the
    RWKV-7 Q4_K_M model's cases. Its whole-stack step and the slot stacks
    of SLOT_STACKS are held after its Engine phase."""
    return []


MODEL_CASES = {"v7": kernel_cases, "v6": kernel_cases6, "v5": kernel_cases5,
               "v4": kernel_cases4, "v7q5": kernel_cases7q5, "v6q8": kernel_cases6q8,
               "v7i8": kernel_cases7i8, "v7nf4": kernel_cases7nf4, "v6i8": kernel_cases6i8,
               "v7q6": kernel_cases7q6, "v7f16": kernel_cases7f16}

# Whole-stack stacks in the slots no driven model reaches, held beside the
# model named: (version, block type or None for an f16 file loaded as bf16),
# the RWKV-7 ones at the 0.1B widths at full depth, the RWKV-6 ones at the
# World 1.6B widths at 4 of its 24 layers, all at a vocabulary of 256 (the
# head is not run); each held layer by layer at SLOT_BATCHES lanes.
SLOT_STACKS = {"v7q6": (("v7", "Q3_K"), ("v7", "Q4_1")),
               "v7f16": (("v6", "Q6_K"), ("v6", "Q4_0"), ("v6", None))}
SLOT_WIDTHS = {"v7": {**_V7_WIDTHS, "n_vocab": 256},
               "v6": dict(n_layer=4, n_emb=2048, head_size=64, n_vocab=256, n_hidden=7168,
                          rank_tm=32, rank_td=64)}
SLOT_BATCHES = {"v7": (4, 1, 16), "v6": (4,)}
SLOT_SEED = 110


def clone_tree(tree):
    """A copy of a tree of tensors in new device memory."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(clone_tree(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


def mega_case(torch, mod, mega, state, x, mask, eps, bf16_peak, f32_peak, label):
    """The whole-stack decode kernel of ``mod`` (``ops/cuda/layer7`` or
    ``ops/cuda/layer56``) at a decode shape: one token for every lane of
    ``state`` through all layers of ``mega`` (``label`` names the model or
    slot stack in the case's name); input copies beyond the first are
    clones in new memory."""
    v7 = hasattr(mod, "layer_scan7")
    scan, plain = ((mod.layer_scan7, mod.layer_scan7_plain) if v7
                   else (mod.layer_scan56, mod.layer_scan56_plain))
    L, C, H, hs, hidden = (mega[k] for k in ("L", "C", "H", "hs", "hidden"))
    version = 7 if v7 else mega["version"]
    B = x.shape[0]

    def make(i):
        if i == 0:
            return (mega, state, x, mask, None, *eps)
        return (clone_tree(mega), clone_tree(state), x.clone(), mask, None, *eps)

    def one_layer(fn, i, x_l, v_first, staged=None, **kw):
        """Layer i alone, as a one-layer slice: (x, state, carry); for
        versions 6 to 4 ``staged`` receives the layer's staged operands;
        ``kw`` goes to the plain version (RWKV-7's ``ln_out``)."""
        m_i = mod.mega_layers(mega, i, i + 1)
        s_i = {k: v[i:i + 1] for k, v in state.items()}
        if v7:
            return fn(m_i, s_i, x_l, mask, None, *eps, (v_first, i), **kw)
        return (*fn(m_i, s_i, x_l, mask, None, *eps, i, staged=staged), None)

    live = mask > 0

    def check(args):
        """Layer by layer: each layer as a one-layer launch on the plain
        chain's input to it, against the plain version of that layer (for
        RWKV-7 its shift states, the LayerNorm outputs, against the plain
        version's, and the rest against the plain version given those
        outputs; and,
        for versions 6 to 4, the layer's x replayed from the kernel's own
        staged operands, at MEGA_REPLAY_TOL; for versions 6 and 5 a layer
        whose x alone is past MEGA_LAYER_TOL, by at most MEGA_FLIP_X times,
        passes when its staged operands are within rounding flips,
        staged_excess(), in at most MEGA_FLIP_LAYERS layers; the worst and
        any failing layer's difference traced to its staged operands by
        attribute()); every layer is checked and logged before a failure
        raises. Then the whole stack in one launch, whose difference from
        the plain version is reported (it grows with depth; PERF.md,
        Findings)."""
        worst = (-1.0, 0.0, 0.0, None)
        replay_worst = 0.0
        flip_layers = []  # layers whose x was held through their staged operands
        failures = []
        x_l, v_first = x, None
        for i in range(L):
            st_p, st_k = ({}, {}) if not v7 else (None, None)
            want = one_layer(plain, i, x_l, v_first, st_p)
            got = one_layer(scan, i, x_l, v_first, st_k)
            # a masked lane's x is unspecified (its state is what it keeps)
            x_live = torch.where(live[:, None], got[0], want[0])
            pairs = {"x": (x_live, want[0]), **{k: (got[1][k], want[1][k]) for k in want[1]}}
            if v7:  # given the kernel's LayerNorm outputs: x, the WKV state, v_first
                given = one_layer(plain, i, x_l, v_first,
                                  ln_out=(got[1]["att_shift"], got[1]["ffn_shift"]))
                pairs.update(x=(x_live, given[0]), wkv=(got[1]["wkv"], given[1]["wkv"]),
                             v_first=(got[2], given[2]))
            else:
                rep = mod.replay_staged(mega, i, state, x_l, mask, *eps, st_k)
                rel = ((rep["x"] - got[0])[live].abs().max() / got[0][live].abs().max()).item()
                replay_worst = max(replay_worst, rel)
                if not rel <= MEGA_REPLAY_TOL:
                    failures.append(f"layer {i}'s x is {rel:.3e} of its max from its replay "
                                    f"on the kernel's staged operands")
            for key, (a, b) in pairs.items():
                err, lim = (a - b).abs().max().item(), MEGA_LAYER_TOL * b.abs().max().item()
                if err <= lim:
                    if err / lim > worst[0]:
                        worst = (err / lim, err, lim,
                                 (i, key, a, b, x_l, st_p, st_k, got[0], want[0]))
                    continue
                if not v7:  # what the difference comes from
                    attribute(torch, case["name"], mega, i, key, a, b, x_l, st_p, st_k,
                              got[0], want[0])
                if key == "x" and not v7 and mega["version"] != 4:
                    ops, steps = staged_excess(st_k, st_p, rep, mega["version"], live)
                    log(f"  {case['name']}: layer {i}'s x off by {err:.3e}, "
                        f"{err / lim:.2f} of {lim:.3e} (at most {MEGA_FLIP_X}), its staged "
                        f"operands' shares of their bounds: "
                        + ", ".join(f"{k} {v:.2f}" for k, v in ops.items())
                        + "; elements of the bf16 ones more than one step from their "
                        "replay " + ", ".join(f"{k} {n} (at most {m:.0f} steps)"
                                    for k, (n, m) in steps.items()))
                    if err <= MEGA_FLIP_X * lim and max(ops.values()) <= 1.0:
                        flip_layers.append(i)
                        continue
                failures.append(f"layer {i}'s {key} off by {err:.3e} (tolerance {lim:.3e})")
            x_l, v_first = want[0], want[2]
        if not v7:
            log(f"  {case['name']}: every layer's x within {replay_worst:.2e} of its max of "
                f"its replay on the kernel's staged operands (tolerance {MEGA_REPLAY_TOL}); "
                f"layers held through their staged operands: {flip_layers or 'none'} "
                f"(at most {MEGA_FLIP_LAYERS})")
            if worst[3] is not None:
                attribute(torch, case["name"], mega, *worst[3])
            if len(flip_layers) > MEGA_FLIP_LAYERS:
                failures.append(f"{len(flip_layers)} layers held through their staged "
                                f"operands, more than {MEGA_FLIP_LAYERS}")
        if failures:
            raise AssertionError(f"{scan.__name__}: " + "; ".join(failures))
        xg, sg = scan(*args)
        xp, sp = plain(*args)
        rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
        log(f"  {case['name']}: whole stack in one launch against the plain version, "
            f"|diff|/max per layer: " + "; ".join(
                f"{k} " + " ".join(f"{rel(sg[k][i], sp[k][i]):.1e}" for i in range(L))
                for k in sp) + f"; x {rel(xg, xp):.1e}")
        if not all(torch.isfinite(t).all() for t in (xg, *sg.values())):
            raise AssertionError(f"{scan.__name__}: non-finite output")
        return worst[1], worst[2]

    ops = mod._operands(mega, x.device)
    weights = sum(a.numel() * a.element_size()
                  for a in (ops.values() if isinstance(ops, dict) else ops) if a is not None)
    state_bytes = sum(a.numel() * a.element_size() for a in state.values())
    # multiply-adds per lane and layer; the WKV step's flops
    if v7:
        D = sum(mega["lora_dims"])
        macs = 4 * C * C + 2 * C * hidden + 2 * D * C
        wkv_flops = 8 * H * hs * hs
    elif version == 4:  # r, k, v, Wo, FFN receptance; FFN key and value
        macs = 5 * C * C + 2 * C * hidden
        wkv_flops = 25 * C
    else:  # r, k, v, g, Wo, FFN receptance; FFN key and value; V6's adapters
        macs = 6 * C * C + 2 * C * hidden + 10 * mega["R"] * C + 2 * mega["D"] * C
        wkv_flops = 6 * H * hs * hs
    # the matrices, LoRA pairs and adapters run on bf16 tensor cores (the
    # codes exact in bf16), the WKV step in f32
    flops = B * L * (2 * macs + wkv_flops)
    ops = ((B * L * 2 * macs, bf16_peak), (B * L * wkv_flops, f32_peak))
    tag = "" if v7 else f"version={version},"
    case = dict(
        name=f"{scan.__name__}[{label},{tag}L={L},B={B},C={C},hidden={hidden}]", kernel=scan,
        shape=(L, B, C) if v7 else (version, L, B, C), L=L, plain=plain, make_args=make,
        check=check,
        # weights once, state in and out, x in and out, the mask
        nbytes=weights + 2 * state_bytes + 8 * B * C + 4 * B,
        flops=flops, fpeak=flops / sum(f / p for f, p in ops))
    return case


def bf16_place(t):
    """Each element's place among the ordered bf16 numbers (neighbours
    differ by 1; +0 and -0 share a place)."""
    import torch

    i = t.view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def staged_excess(st_k, st_p, rep, version, live):
    """Each operand a one-layer launch staged for the ``live`` lanes (versions
    6 and 5), as a share of its bound: the f32 products (r/k/v/g, the FFN
    receptance) against the plain version's, max|kernel − plain| over
    MEGA_LAYER_TOL·max|plain|; the bf16 inputs to Wo (y) and to the FFN
    value (khid) against their replay ``rep`` from the kernel's own earlier
    operands (layer56.replay_staged: y from its r/k/v/g, khid from its y),
    the most bf16 steps an element lies from its replay (1: a rounding the
    order of f32 sums flipped), an element below MEGA_LAYER_TOL·max|replay|
    counted in steps of that floor (the bf16 step of a value near 0 is
    finer than those sums' order moves it). Also, for the bf16 operands, how
    many elements lie more than one step from their replay with no floor,
    and the most steps, for the log."""
    out, steps = {}, {}
    for op in ("rkvg", "y", "khid", "rf"):
        a = st_k[op][..., live, :]
        if op in ("y", "khid"):
            b = rep[op][live, :]
            places = (bf16_place(a) - bf16_place(b)).abs().float()
            a, b = a.float(), b.float()
            floor = MEGA_LAYER_TOL * b.abs().max().item()
            small = a.abs().maximum(b.abs()) < floor
            floor_step = 2.0 ** (math.floor(math.log2(floor)) - 7) if floor > 0 else 1.0
            out[op] = places.where(~small, (a - b).abs() / floor_step).max().item()
            steps[op] = (int((places > 1).sum()), places.max().item())
            continue
        a, b = a.float(), st_p[op][..., live, :].float()
        parts = ([(p, a[j], b[j]) for j, p in enumerate("rkvg" if version != 4 else "rk")]
                 if op == "rkvg" else [(op, a, b)])
        for name, x, y in parts:
            lim = MEGA_LAYER_TOL * y.abs().max().item()
            d = (x - y).abs().max().item()
            out[name] = d / lim if lim > 0 else (0.0 if d == 0 else math.inf)
    return out, steps


def _layer_mat(mega, i):
    """Layer i's quantized product by matrix name, in plain PyTorch."""
    from web_rwkv_gguf_tpu_torch.ops.cuda.layer7 import slot_gemv_plain

    return lambda name, a: slot_gemv_plain(mega["forms"][name], mega["mats"][name], i,
                                           a.float())


def attribute(torch, name, mega, i, key, got, want, x_in, st_p, st_k, x_got, x_want):
    """Log where a whole-stack case's worst difference from its plain
    version sits (layer i, array ``key``) and what it comes from: which of
    the layer's staged operands differ between the kernel and the plain
    version (the bf16 inputs to Wo and to the FFN value, element by
    element; the f32 projections, × their max), and at x's largest
    difference in that layer its part from Wo, its part from the FFN
    value, and the largest move there of one differing element of the FFN
    value's bf16 input alone."""
    mat = _layer_mat(mega, i)
    d = (got - want).abs()
    at = tuple(int(j) for j in torch.unravel_index(d.argmax(), d.shape))
    words = [f"worst: layer {i}'s {key} at {at}, kernel {got[at].item():.7g}, plain "
             f"{want[at].item():.7g}"]
    for op in ("y", "khid"):
        a, b = st_k[op].float(), st_p[op].float()
        diff = a != b
        n = int(diff.sum())
        big = (a - b).abs().max().item()
        words.append(f"{op} (bf16) differs in {n} of {a.numel()} elements, at most by {big:.4g}")
    proj = "rk" if mega["version"] == 4 else "rkvg"  # version 4 stages no v
    for j, p in enumerate(proj):
        a, b = st_k["rkvg"][j], st_p["rkvg"][j]
        words.append(f"{p} {((a - b).abs().max() / b.abs().max()).item():.2e}")
    words.append(f"rf {((st_k['rf'] - st_p['rf']).abs().max() / st_p['rf'].abs().max()).item():.2e}")
    dx = (x_got - x_want).abs()
    b_, c = (int(j) for j in torch.unravel_index(dx.argmax(), dx.shape))
    wo = mat("att.Wo", st_k["y"]) - mat("att.Wo", st_p["y"])
    ffn = (st_k["rf"].sigmoid() * mat("ffn.Wv", st_k["khid"])
           - st_p["rf"].sigmoid() * mat("ffn.Wv", st_p["khid"]))
    words.append(f"x at ({b_}, {c}) off by {(x_got - x_want)[b_, c].item():.4g}: Wo part "
                 f"{wo[b_, c].item():.4g}, FFN value part {ffn[b_, c].item():.4g}")
    flips = (st_k["khid"][b_] != st_p["khid"][b_]).nonzero()[:, 0][:4096]
    if flips.numel():
        one = torch.zeros(flips.numel(), st_k["khid"].shape[1], device=flips.device)
        one[torch.arange(flips.numel(), device=flips.device), flips] = (
            st_k["khid"][b_, flips].float() - st_p["khid"][b_, flips].float())
        move = mat("ffn.Wv", one)[:, c] * st_k["rf"][b_, c].sigmoid()
        j = int(move.abs().argmax())
        words.append(f"its largest single khid flip (element {int(flips[j])}, plain "
                     f"{st_p['khid'][b_, flips[j]].item():.6g}, kernel "
                     f"{st_k['khid'][b_, flips[j]].item():.6g}) moves it by "
                     f"{move[j].item():.4g}")
    log(f"  {name}: " + "; ".join(words))


def phase_times(torch, case, n_phases, names):
    """µs per layer by phase of the whole-stack kernel (the device clock
    after each grid barrier), median of 5 launches; logged."""
    L = case["L"]
    stamps = []
    for _ in range(5):
        ns = torch.zeros(1 + n_phases * L, dtype=torch.int64, device="cuda")
        case["kernel"](*case["make_args"](0), phase_ns=ns)
        stamps.append(ns.diff().view(L, n_phases).double().mean(0) / 1e3)
    per_phase = torch.stack(stamps).median(0).values.tolist()
    log(f"  {case['name']}: µs per layer by phase, each up to its grid barrier, median "
        f"of 5 launches: " + ", ".join(f"{n} {t:.2f}" for n, t in zip(names, per_phase))
        + f"; {sum(per_phase) * L:.1f} µs for {L} layers, {n_phases * L} barriers")


def gemm_compare(got, want):
    return (got - want).abs().max().item(), GEMM_TOL * want.abs().max().item()


def scan_compare(got, want):
    (y1, s1), (y0, s0) = got, want
    err = max((y1 - y0).abs().max().item(), (s1 - s0).abs().max().item())
    return err, WKV_TOL * max(y0.abs().max().item(), s0.abs().max().item())


# --------------------------------------------------------------------------
# model phases
# --------------------------------------------------------------------------


COUNTED = ("q4k_gemv", "q4k_gemm", "q6k_gemv", "q6k_gemm", "qkb_gemv", "qkb_gemm", "qs_gemv",
           "qs_gemm", "nf4_gemv", "nf4_gemm", "quant_gemv_grouped", "att_core7_step",
           "wkv7_scan", "layer_scan7", "wkv6_scan", "layer_scan56", "wkv4_scan")


def matmul_kernel(mat, n):
    """The kernel ``Matrix.matmul`` launches for ``mat`` at n rows: its
    form's family (native Q4_K factors, Q5_K/Q2_K factors, Q6_K/Q3_K
    factors, f32 group scales or Int8, NF4/SF4) and the gate
    (``Matrix.takes_gemv``); None for a dense matrix (torch.matmul)."""
    a = mat.arrays
    if mat.kind == "dense":
        return None
    if mat.kind in ("int8", "nf4"):
        family = "qs" if mat.kind == "int8" else "nf4"
    elif "sc6" in a:
        family = "q4k" if mat.kind == "qk" else "qkb"
    else:
        family = "q6k" if "q6s" in a else "qs"
    return f"{family}_gemv" if mat.takes_gemv(n) else f"{family}_gemm"


def expected_chunk(chunked_min_t, spec, layers, B, T):
    """Launches of one ``forward_chunk`` of B lanes × T tokens on the
    per-layer path, by kernel: each layer's matrices (``spec["matrices"]``:
    six for RWKV-7, eight for RWKV-6 and -5, seven for RWKV-4) at n = B·T
    rows (gemv or GEMM by the gate), and each layer's WKV kernel at this T
    (``spec["wkv"]``: for RWKV-7 the attention core at T=1 and the scan at
    2 ≤ T < 128, for RWKV-6 and -5 the V6 scan below T=128, T=1 included,
    for RWKV-4 its scan at every T; from T=128 the chunk-parallel WKV is
    PyTorch matmuls). A layer of unrolled params (``models.unroll_params``)
    that carries ``att["Wrkv_g"]`` takes r, k and v in one
    ``quant_gemv_grouped`` launch at B = T = 1 where its Wo is quantized."""
    want = collections.Counter()
    for blk in layers:
        grouped = B * T == 1 and "Wrkv_g" in blk["att"] and blk["att"]["Wo"].kind != "dense"
        for part, name in spec["matrices"]:
            if not (grouped and (part, name) in _RKV):
                want[matmul_kernel(blk[part][name], B * T)] += 1
        if grouped:
            want["quant_gemv_grouped"] += 1
    at_1, below, above = spec["wkv"]
    wkv = at_1 if T == 1 else (below if T < chunked_min_t else above)
    if wkv is not None:
        want[wkv] += len(layers)
    return want


def compare_seed(spec):
    """The seed of a model's card-vs-CPU file."""
    return spec.get("compare_seed", spec["seed"] + 1)


def build_file(tag, n_layer, seed):
    """The bytes of model ``tag``'s synthetic file (in its placement, or
    f16 for a requantized model) at ``n_layer`` layers and the seconds its
    build took (run in a worker process)."""
    import numpy as np

    from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
    from web_rwkv_gguf_tpu_torch.utils import synthetic

    spec = MODELS[tag]
    if spec["quantize"] is None:
        placement = dict(dtype=np.float16)
    else:
        placement = dict(quantize=GgmlDType[spec["quantize"]],
                         head_quantize=GgmlDType[spec["head_quantize"]])
    t0 = time.perf_counter()
    raw = getattr(synthetic, spec["make"])(**{**spec["widths"], "n_layer": n_layer}, seed=seed,
                                           **placement)
    return raw, time.perf_counter() - t0


def build_slot_file(version, kind, seed):
    """The bytes of a slot stack's synthetic file (SLOT_STACKS: ``kind`` a
    block type, or None for f16) and the seconds its build took (run in a
    worker process)."""
    import numpy as np

    from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
    from web_rwkv_gguf_tpu_torch.utils import synthetic

    placement = dict(dtype=np.float16) if kind is None else dict(quantize=GgmlDType[kind])
    t0 = time.perf_counter()
    raw = getattr(synthetic, f"make_{version}_gguf")(**SLOT_WIDTHS[version], seed=seed,
                                                     **placement)
    return raw, time.perf_counter() - t0


def model_convention(reader):
    """The model-convention tensors of a GGUF file (``blocks.0.att.key.weight``
    ...), each in its stored type (f16 or f32), for a .safetensors file."""
    import numpy as np

    from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType

    out = {}
    for name in reader.names():
        if name in reader.name_map and (name.startswith("blocks.")
                                        or name.split(".")[0] in ("emb", "ln_out", "head")):
            f16 = reader.tensors[reader.name_map[name]].dtype == GgmlDType.F16
            out[name] = reader.tensor(name, np.float16 if f16 else np.float32)
    return out


def load(models, raw, spec, device):
    """``models.load_model`` of a model file, requantized by the model's
    scheme where it has one."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.quant import QuantScheme

    quant = QuantScheme[spec["quant"]] if "quant" in spec else None
    return models.load_model(GgufFile(raw), quant=quant, device=device)


def serve(torch, models, info, params, prompts, steps):
    """Answer each prompt at batch 1: the prompt prefilled as one chunk
    through forward_chunk, its last logits through logits_head and a
    greedy pick, then ``steps`` greedy tokens from make_generator.
    Returns the tokens per request and the seconds of prefill and of
    generation."""
    dev = params["emb"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = models.make_generator(info, steps=steps)
    out, t_prompt, t_gen = [], 0.0, 0.0
    for prompt in prompts:
        sync()
        t0 = time.perf_counter()
        state = models.init_state(info, 1, device=dev)
        x, state = models.forward_chunk(info, params, state,
                                        torch.tensor([prompt], device=dev),
                                        torch.tensor([len(prompt)], device=dev))
        logits = models.logits_head(params, x[:, -1])
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


def profile(torch, fn, per):
    """Device kernel time of one ``fn()`` call divided by ``per``, in all
    and by kernel, from torch.profiler (device-side kernel events only, so
    no time is counted twice); None where the profiler saw no device time.
    Also the wall µs under the profiler, divided by ``per``. ``fn`` runs
    once before, unprofiled."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
            rows.append((us / per, ev.key, ev.count / per))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return (total if total > 0 else None), wall / per * 1e6, rows


def log_profile(label, busy, prof_wall_us, rows, wall_us, unit):
    if busy is None:
        log(f"profile ({label}): no device time recorded (not measured)")
        return
    log(f"profile ({label}): device kernel time {busy:.1f} us/{unit}, "
        f"{sum(r[2] for r in rows):.1f} kernels/{unit}; busy share "
        f"{busy / wall_us:.3f} of the unprofiled {wall_us:.1f} us/{unit} "
        f"({prof_wall_us:.1f} us/{unit} under the profiler)")
    for us, key, count in rows[:15]:
        log(f"  {us:9.2f} us/{unit}  x{count:<8.2f} {key[:90]}")


def engine_plans(runtime, _bucket, lengths, chunk):
    """The chunk lengths T (bucketed as the Engine buckets them) that the
    scheduler plans for prompts of ``lengths``."""
    inp = runtime.RnnInput([runtime.RnnInputBatch([0] * n) for n in lengths], chunk)
    Ts = []
    while inp.num_token:
        plan = inp.plan()
        Ts.append(_bucket(max(p.len for p in plan), inp.token_chunk_size))
        inp.step(plan)
    return Ts


def full_input(runtime, _bucket, rng, vocab):
    """The FULL-lane infer input, its plan and the head's (padded) row
    count."""
    opts = {"full": runtime.RnnOption.FULL, "last": runtime.RnnOption.LAST}
    inp = runtime.RnnInput(
        [runtime.RnnInputBatch([int(t) for t in rng.integers(0, vocab, n)], opts[o])
         for n, o in FULL_LANES], ENGINE_CHUNK)
    plan = inp.plan()
    rows = sum(p.len if p.option == runtime.RnnOption.FULL else int(p.len > 0)
               for p in plan if p.option is not None)
    return inp, plan, _bucket(rows, 1 << 30)


def run_chunks(torch, models, info, params, chunks, device, hooks=None):
    """Per chunk, on the host: the live lanes' last-token logits and the
    state; ``chunks`` is a list of (tokens [B, T], lengths [B]); ``hooks``
    go to the forward and the head."""
    st = models.init_state(info, len(chunks[0][1]), device=device)
    out = []
    for toks, lens in chunks:
        t = torch.as_tensor(toks, device=device)
        n = torch.as_tensor(lens, device=device)
        x, st = models.forward_chunk(info, params, st, t, n, hooks=hooks)
        live = (n > 0).nonzero()[:, 0]  # a zero-length lane's x is unspecified
        logits = models.logits_head(params, x[live, n[live] - 1], hooks=hooks)
        out.append({"logits": logits.cpu(), **{k: v.cpu() for k, v in st.items()}})
    return out


RECURRENT = ("wkv", *V4_VIEWS)  # the WKV states, held layer by layer


def held(chunk):
    """The arrays of one chunk's result that the comparison holds: all as
    they are, but RWKV-4's aa and bb as V4_VIEWS (nan or -inf where pp
    holds the sentinel: a lane that has not run)."""
    if "aa" not in chunk:
        return chunk
    out = {k: v for k, v in chunk.items() if k not in ("aa", "bb")}
    out["aa/bb"] = chunk["aa"] / chunk["bb"]
    out["pp+ln bb"] = chunk["pp"] + chunk["bb"].log()
    return out


def rel_diff(got, want):
    """Per chunk: max|got - want| / max|want| for the logits and the shift
    states, and for each WKV state array of each layer ("wkv.<layer>";
    RWKV-4's "aa/bb.<layer>", "pp.<layer>", "pp+ln bb.<layer>") against
    that layer's max. RWKV-4's views are held over the entries that left
    the F32_MIN sentinel (a lane that has not run keeps it, which would
    make a relative check empty); a sentinel entry of pp that differs, or
    a view that is not finite, counts as inf."""
    from web_rwkv_gguf_tpu_torch.ops.wkv import F32_MIN

    per_chunk = []
    for g, w in zip(got, want):
        g, w = held(g), held(w)
        rel = {}
        for key in w:
            parts = ([(f"{key}.{i}", i, g[key][i], w[key][i]) for i in range(w[key].shape[0])]
                     if key in RECURRENT else [(key, None, g[key], w[key])])
            for name, i, a, b in parts:
                if key in V4_VIEWS:
                    sentinel = w["pp"][i] == F32_MIN
                    if not bool((g["pp"][i][sentinel] == F32_MIN).all()):
                        rel[name] = math.inf
                        continue
                    a, b = a[~sentinel], b[~sentinel]
                if b.numel() == 0:
                    rel[name] = 0.0
                    continue
                d = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                rel[name] = d if math.isfinite(d) else math.inf
        per_chunk.append(rel)
    return per_chunk


def wkv_max_at(got, want):
    """Per chunk and layer: the (lane, head) of the largest WKV state
    difference (RWKV-7 to -5), or the (lane, channel) of the largest aa/bb
    difference (RWKV-4)."""
    out = []
    for g, w in zip(got, want):
        g, w = held(g), held(w)
        key = "wkv" if "wkv" in w else "aa/bb"
        d = (g[key] - w[key]).abs().nan_to_num(0.0)
        d = d.amax(dim=(3, 4)) if key == "wkv" else d  # [L, B, H] or [L, B, C]
        out.append([divmod(int(d[i].argmax()), d.shape[2]) for i in range(d.shape[0])])
    return out


def card_cpu_limit(key):
    """The shifts, the logits and layer 0's WKV state at CARD_CPU_TOL, later
    layers' WKV state at CARD_CPU_WKV_TOL."""
    name, _, layer = key.partition(".")
    if name not in RECURRENT or layer == "0":
        return CARD_CPU_TOL
    return CARD_CPU_WKV_TOL


def noisy_params(torch, Matrix, params, seed, device):
    """``params`` with every matrix replaced by one that moves each element
    of its product by one f32 ulp, up or down (each with probability
    1/4), from a generator seeded with ``seed``: the size of the
    differences that another summation order makes, as between the card
    and the CPU. (Moving the input instead changes almost nothing: the
    products round their input to bf16 first.)"""
    gen = torch.Generator(device=device).manual_seed(seed)

    class Noisy(Matrix):
        def layer(self, i):
            return Noisy(self.kind, self.shape, {k: a[i] for k, a in self.arrays.items()})

        def matmul(self, x):
            y = super().matmul(x)
            u = torch.rand(y.shape, generator=gen, device=y.device)
            inf = torch.full_like(y, math.inf)
            return torch.where(u < 0.25, torch.nextafter(y, inf),
                               torch.where(u < 0.5, torch.nextafter(y, -inf), y))

    def swap(tree):
        if isinstance(tree, Matrix):
            return Noisy(tree.kind, tree.shape, tree.arrays)
        if isinstance(tree, dict):
            return {k: swap(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [swap(v) for v in tree]
        return tree
    return swap(params)


def sensitivity(torch, models, Matrix, info, params, chunks, device, clean):
    """How far the result of ``chunks`` moves under one-ulp changes of
    every matmul's product on one device: per noise seed, rel_diff against the
    clean run and wkv_max_at. Checks first that a rerun is identical to
    the clean run (the device is deterministic, so every difference
    comes from the noise)."""
    again = run_chunks(torch, models, info, params, chunks, device)
    if any(v != 0.0 for rel in rel_diff(again, clean) for v in rel.values()):
        raise AssertionError(f"two clean runs on {device} differ")
    out = {}
    for seed in SENSITIVITY_SEEDS[device]:
        noisy = run_chunks(torch, models, info,
                           noisy_params(torch, Matrix, params, seed, device), chunks, device)
        out[seed] = (rel_diff(noisy, clean), wkv_max_at(noisy, clean))
    return out


def write_bytes(path, fn, *args):
    """``fn(*args)`` (in a worker process): its bytes written to ``path``,
    the rest of what it returns given back. A file of up to ~1.2 GB crosses
    the pool's one result pipe slowly, each after the last; the disk does
    not serialise them."""
    raw, *rest = fn(*args)
    with open(path, "wb") as f:
        f.write(raw)
    return rest


class FileJob:
    """A file built by ``fn(*args)`` in a worker of ``pool``, handed over
    through ``path``: ``get()`` gives what ``fn`` returned, the bytes read
    back (once)."""

    def __init__(self, pool, path, fn, *args):
        self.path = path
        self.result = pool.apply_async(write_bytes, (path, fn, *args))

    def wait(self):
        self.result.wait()

    def get(self):
        rest = self.result.get()
        with open(self.path, "rb") as f:
            raw = f.read()
        os.unlink(self.path)
        return (raw, *rest)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this run needs one", file=sys.stderr)
        return 1
    try:
        import web_rwkv_gguf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repo ({e})",
              file=sys.stderr)
        return 1
    # the models to run: all, or those named in the one argument (tags of
    # MODELS, comma-separated, in the order given)
    tags = sys.argv[1].split(",") if len(sys.argv) > 1 else list(MODELS)
    if any(tag not in MODELS for tag in tags):
        print(f"chip_smoke: models are named from {list(MODELS)}", file=sys.stderr)
        return 2
    # the model files are built in worker processes while the kernels
    # build, each handed over on disk; every worker is stopped and every
    # file removed on the way out
    workers = multiprocessing.get_context("spawn").Pool(5)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        names = itertools.count()

        def job(fn, *args):
            return FileJob(workers, os.path.join(tmp, f"file{next(names)}"), fn, *args)

        files = {}
        for tag in tags:
            spec = MODELS[tag]
            files[tag] = {"full": job(build_file, tag, spec["widths"]["n_layer"], spec["seed"]),
                          "compare": job(build_file, tag, COMPARE_LAYERS, compare_seed(spec))}
            for j, (version, kind) in enumerate(SLOT_STACKS.get(tag, ())):
                files[tag][f"slot {version} {kind or 'bf16'}"] = job(
                    build_slot_file, version, kind, SLOT_SEED + j)
            if "convert" in spec.get("apps", ()):
                files[tag]["convert"] = job(convert_checkpoint)
        return run(np, torch, files)
    finally:
        workers.terminate()
        workers.join()
        shutil.rmtree(tmp, ignore_errors=True)


def run(np, torch, files) -> int:
    from web_rwkv_gguf_tpu_torch import io as rio
    from web_rwkv_gguf_tpu_torch import models, runtime
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile, GgufWriter
    from web_rwkv_gguf_tpu_torch.models import matrix as matrix_mod
    from web_rwkv_gguf_tpu_torch.models.forward import WKV7_CHUNKED_MIN_T
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.models.loader import layer_params
    from web_rwkv_gguf_tpu_torch.models.matrix import Matrix
    from web_rwkv_gguf_tpu_torch.ops.cuda import build
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7 as l7
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer56 as l56
    from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv4, wkv6
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv7 as core
    from web_rwkv_gguf_tpu_torch.runtime.engine import _bucket

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

    # every model file before the first timed phase, so that no file build
    # or transfer shares the host with the timings
    t0 = time.perf_counter()
    for tag in files:
        for f in files[tag].values():
            f.wait()
    log(f"model files: waited {time.perf_counter() - t0:.1f} s for the worker processes")

    # ---- kernels against their plain versions -------------------------------
    rng = np.random.default_rng(ENGINE_SEED)
    engine_prompts = [[int(t) for t in rng.integers(0, VOCAB, n)] for n in ENGINE_LENGTHS]
    full_inp, full_plan, full_rows = full_input(runtime, _bucket, rng, VOCAB)
    log("kernels (each against its plain PyTorch version, same inputs):")
    entries = []
    kmods = {"matmul": mm, "wkv7": core, "wkv6": wkv6, "wkv4": wkv4}
    cases = [case for tag in files
             for case in MODEL_CASES[tag](torch, kmods, bf16_peak, f32_peak, full_rows)]
    sources = {"q4k_gemv": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/q4k_gemv.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:793"),
               "q6k_gemv": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/q6k_gemv.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:629"),
               "att_core7": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/att_core7.cu",
                             "web_rwkv_gguf_tpu/ops/pallas/wkv7.py:108"),
               "q4k_gemm": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/qk_gemm.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:1225"),
               "q6k_gemm": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/qk_gemm.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:1225"),
               "qs_gemv": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/qs_gemv.cu",
                           "web_rwkv_gguf_tpu/ops/pallas/matmul.py:939"),
               "nf4_gemv": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/nf4_gemv.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:1002"),
               "quant_gemv_grouped": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/gemv_grouped.cu",
                                      "web_rwkv_gguf_tpu/ops/pallas/matmul.py:1154"),
               "nf4_gemm": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/qk_gemm.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:1225"),
               "qkb_gemv": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/qkb_gemv.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:587"),
               "qs_gemm": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/qk_gemm.cu",
                           "web_rwkv_gguf_tpu/ops/pallas/matmul.py:1225"),
               "qkb_gemm": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/qk_gemm.cu",
                            "web_rwkv_gguf_tpu/ops/pallas/matmul.py:1225"),
               "wkv7_scan": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/wkv7_scan.cu",
                             "web_rwkv_gguf_tpu/ops/pallas/wkv7.py:176"),
               "layer_scan7": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/layer7.cu",
                               "web_rwkv_gguf_tpu/ops/pallas/layer7.py:1011"),
               "wkv6_scan": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/wkv6_scan.cu",
                             "web_rwkv_gguf_tpu/ops/pallas/wkv456.py:46"),
               "layer_scan56": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/layer56.cu",
                                "web_rwkv_gguf_tpu/ops/pallas/layer56.py:445"),
               "wkv4_scan": ("web_rwkv_gguf_tpu_torch/ops/cuda/csrc/wkv4_scan.cu",
                             "web_rwkv_gguf_tpu/ops/pallas/wkv456.py:143")}

    def add_entry(case, fields):
        kname = case["name"].split("[")[0]
        entries.append({"name": case["name"], "route": "cuda", "source": sources[kname][0],
                        "replaces": sources[kname][1], "launches": None, **fields})

    for case in cases:
        add_entry(case, run_kernel_case(torch, case, hbm))
    log(f"kernel cases: done {time.perf_counter() - t_start:.1f} s into the run")

    counters = {"q4k_gemv": mm.q4k_gemv, "q4k_gemm": mm.q4k_gemm,
                "q6k_gemv": mm.q6k_gemv, "q6k_gemm": mm.q6k_gemm,
                "qkb_gemv": mm.qkb_gemv, "qkb_gemm": mm.qkb_gemm,
                "qs_gemv": mm.qs_gemv, "qs_gemm": mm.qs_gemm,
                "nf4_gemv": mm.nf4_gemv, "nf4_gemm": mm.nf4_gemm,
                "quant_gemv_grouped": mm.quant_gemv_grouped,
                "att_core7_step": core.att_core7_step, "wkv7_scan": core.wkv7_scan,
                "layer_scan7": l7.layer_scan7, "wkv6_scan": wkv6.wkv6_scan,
                "layer_scan56": l56.layer_scan56, "wkv4_scan": wkv4.wkv4_scan}
    path_launches = {}  # main path -> kernel -> launches
    path_shapes = {}  # main path -> kernel -> Counter of launches by shape

    def counted(path, want, drive):
        """Drive one main path with every count at 0; check the counts
        against ``want`` (or ``want(result)``, where the path's length
        depends on what it returned)."""
        for fn in counters.values():
            fn.launches = 0
            fn.shapes.clear()
        result = drive()
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        if callable(want):
            want = want(result)
        want = {name: want.get(name, 0) for name in COUNTED}
        log(f"{path} launches: {got} (expected {want})")
        log(f"{path} launches by shape: "
            + "; ".join(f"{k} {dict(fn.shapes)}" for k, fn in counters.items() if fn.shapes))
        if got != want:
            raise AssertionError(f"{path} did not run through every kernel as expected")
        path_launches[path] = got
        path_shapes[path] = {k: collections.Counter(fn.shapes) for k, fn in counters.items()}
        return result

    def hold_stack(label, mega_key, mega, state, dec_x, batches):
        """The whole-stack decode kernel against its plain version, layer
        by layer, on ``state``'s four lanes (lane 2 frozen at B=4; lanes
        repeated to each of ``batches``), timed, with its phase times;
        every batch is checked and logged before a failure raises."""
        v7 = mega_key == "mega7"
        scan_mod = l7 if v7 else l56
        B4 = dec_x.shape[0]
        mask = torch.tensor([1.0, 1.0, 0.0, 1.0], device="cuda")
        eps = (LN_EPS, GN_EPS, L2_EPS) if v7 else (LN_EPS, GN_EPS)
        names = l7.PHASES if v7 else l56.PHASES[mega["version"]]
        log(f"{label} whole-stack decode kernel (against its plain version, same inputs, "
            f"layer by layer):")
        failed = []
        for B in batches:
            lanes = torch.arange(B, device="cuda") % B4
            case = mega_case(torch, scan_mod, mega,
                             {k: v[:, lanes].contiguous() for k, v in state.items()},
                             dec_x[lanes], mask if B == B4 else torch.ones(B, device="cuda"),
                             eps, bf16_peak, f32_peak, label)
            try:
                add_entry(case, run_kernel_case(torch, case, hbm))
            except AssertionError as e:
                log(f"  {case['name']}: FAILED: {e}")
                failed.append(case["name"])
                continue
            cases.append(case)
            phase_times(torch, case, len(names), names)
        if failed:
            raise AssertionError(f"{label}: the whole-stack kernel disagrees with its plain "
                                 f"version ({failed})")

    def slot_stack(label, version, kind, raw):
        """A stack in a slot no driven model reaches (SLOT_STACKS): loaded,
        arranged by ``prepare_decode`` in its slot, three decode steps of
        four lanes through the whole-stack kernel for a state, then held by
        hold_stack."""
        info, params = models.load_model(GgufFile(raw), device="cuda")
        mega_key = "mega7" if version == "v7" else "mega56"
        prepared = models.prepare_decode(params, info, 4)
        form = (l7.descriptor(l7.FORM_DENSE, 0, 0) if kind is None
                else l7.descriptor(l7.FORM_Q6K, 1, 16) if kind in ("Q6_K", "Q3_K")
                else l7.descriptor(l7.FORM_QS_NIB, 0, 32))
        if mega_key not in prepared or set(prepared[mega_key]["forms"].values()) != {form}:
            raise AssertionError(f"{label}: the stack did not take its slot {form}")
        state = models.init_state(info, 4, device="cuda")
        for step in range(3):
            toks = torch.tensor([[11 + 17 * step + 5 * b] for b in range(4)], device="cuda")
            _, state = models.forward_chunk(info, prepared, state, toks,
                                            torch.ones(4, dtype=torch.long, device="cuda"))
        dec_x = models.embed_tokens(params, torch.tensor([[7], [8], [9], [10]],
                                                         device="cuda"))[:, 0]
        hold_stack(label, mega_key, prepared[mega_key], state, dec_x, SLOT_BATCHES[version])

    def last_logits(eng, prompts):
        """Each lane's logits after its prompt, through ``Engine.infer`` from
        a reset state (numpy, one row a lane)."""
        eng.reset_state()
        inp = runtime.RnnInput([runtime.RnnInputBatch(list(p)) for p in prompts], ENGINE_CHUNK)
        last = [None] * len(prompts)
        while inp.num_token:
            for b, o in enumerate(eng.infer(inp)):
                if len(o):
                    last[b] = o[-1]
        return np.stack(last)

    def rel_err(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    def dense_against_quantized(tag, info, params, eng, busy_pre, n_pre, t_pre):
        """Phase (a): the Engine's prefill on its dense copy against an
        Engine of the same lanes with ``prefill_dense=False``: device µs a
        prompt token of each, and how far apart each lane's last logits sit
        at full depth (logged; dense_logits holds them on two layers)."""
        eng_q = runtime.Engine(info, params, num_batch=len(ENGINE_LENGTHS),
                               token_chunk_size=ENGINE_CHUNK, prefill_dense=False,
                               device="cuda")
        eng_q.generate(engine_prompts, 1)  # first call: warm-up
        eng_q.reset_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng_q.generate(engine_prompts, 1)
        torch.cuda.synchronize()
        t_q = time.perf_counter() - t0
        busy_q, _, rows_q = profile(
            torch, lambda: (eng_q.reset_state(), eng_q.generate(engine_prompts, 1)), n_pre)
        gemm_q = sum(us for us, key, _ in rows_q if "qk_gemm_kernel" in key)
        if busy_pre is None or busy_q is None:
            log(f"{tag} prefill with and without the dense copy: no device time recorded "
                "(not measured)")
        else:
            log(f"{tag} prefill device us a prompt token: dense copy {busy_pre:.2f}, quantized "
                f"{busy_q:.2f} (qk_gemm_kernel {gemm_q:.2f}); quantized / dense "
                f"{busy_q / busy_pre:.3f}; wall ms a prompt token {t_pre / n_pre * 1e3:.3f} "
                f"against {t_q / n_pre * 1e3:.3f}, on {smi}")
        err = rel_err(last_logits(eng, engine_prompts), last_logits(eng_q, engine_prompts))
        log(f"{tag} prefill logits at full depth, dense copy against quantized: max|d-q|/max|q| "
            f"{err:.3e} (not held here: {info.num_layer} random layers amplify the two "
            f"rounding classes apart; held on the {COMPARE_LAYERS}-layer model below)")

    def dense_logits(tag, spec, info2, p_gpu):
        """The dense weights against the quantized ones on the card, on the
        card-vs-CPU model (COMPARE_LAYERS layers; at full depth the random
        layers amplify any rounding difference chaotically): every lane's
        logits after its prompt with and without the dense prefill copy; for
        the pool's model also one decode step of 16 lanes on dense weights
        against quantized ones, from the same state. Each pair is held
        within DENSE_TOL·max, or within twice the quantized path's own
        distance from the model's exact function (the same lanes on f32
        weights, measured here) where that is larger: a dense copy no less
        exact than the quantized path sits at most that far from it."""
        kw = dict(token_chunk_size=ENGINE_CHUNK, device="cuda")
        B4 = len(ENGINE_LENGTHS)
        exact = models.densify_matrices(p_gpu, torch.float32)
        runs = {"prefill, dense copy against quantized (B=4)": [
            last_logits(runtime.Engine(info2, p, B4, prefill_dense=d, unroll=u, **kw),
                        engine_prompts)
            for p, d, u in ((p_gpu, True, None), (p_gpu, False, None), (exact, False, False))]}
        if spec.get("pool"):
            prompts, _ = pool_prompts()
            quant = runtime.Engine(info2, p_gpu, 16, decode_dense=False, prefill_dense=False,
                                   **kw)
            runs["B=16 one decode step from the same state, dense against quantized"] = (
                decode_step(quant, [runtime.Engine(info2, p_gpu, 16, decode_dense=True, **kw),
                                    quant, runtime.Engine(info2, exact, 16, decode_dense=False,
                                                          prefill_dense=False, unroll=False,
                                                          **kw)], prompts[:16]))
        failed = []
        for label, (dense, quant_, exact_) in runs.items():
            err, spread = rel_err(dense, quant_), rel_err(quant_, exact_)
            limit = max(DENSE_TOL, 2 * spread)
            log(f"{tag} {label}, L={COMPARE_LAYERS}: max|d-q|/max|q| {err:.3e} (limit "
                f"{limit:.3e}); quantized against f32 weights {spread:.3e}, dense against f32 "
                f"weights {rel_err(dense, exact_):.3e}")
            if not err <= limit:
                failed.append(label)
        if failed:
            raise AssertionError(f"{tag}: the dense weights disagree with the quantized ones "
                                 f"({failed})")

    def decode_dense8(tag, spec, info, params):
        """Phase (b), RWKV-6: an Engine of 8 lanes decodes on dense weights by
        default (the whole-stack kernel's dense slot): one step, counted."""
        L = info.num_layer
        e8 = runtime.Engine(info, params, num_batch=8, token_chunk_size=ENGINE_CHUNK,
                            device="cuda")
        dense_slot = l7.descriptor(l7.FORM_DENSE, 0, 0)
        if (e8.params_quantized is not params or "mega56" not in e8.params
                or set(e8.params["mega56"]["forms"].values()) != {dense_slot}):
            raise AssertionError(f"{tag}: Engine(num_batch=8) did not decode in the dense slot")
        prompts8 = [engine_prompts[i % 4][:12 + i] for i in range(8)]
        Ts = engine_plans(runtime, _bucket, [len(p) for p in prompts8], ENGINE_CHUNK)
        e8_layers = layer_params(e8.params, L)
        want = collections.Counter({"layer_scan56": 1})
        for T in Ts:
            want += expected_chunk(WKV7_CHUNKED_MIN_T, spec, e8_layers, 8, T)
        toks = counted(f"{tag} engine decode on dense weights (B=8, one step)", want,
                       lambda: e8.generate(prompts8, 2, segment=1))
        if [len(t) for t in toks] != [2] * 8:
            raise AssertionError(f"{tag}: Engine(num_batch=8) gave {toks}")
        log(f"{tag} engine at B=8: auto decode_dense (dense_cache_bytes "
            f"{models.dense_cache_bytes(params)}), prompt chunks T={Ts}, one decode step in "
            f"layer_scan56's dense slot; tokens {toks[0]}")

    def decode_segments(info, engines, groups, steps):
        """Wall seconds and device µs a step of one decode segment of
        ``steps`` steps on each engine, dispatched engine by engine before
        anything is read back (as ``EnginePool.generate`` dispatches them),
        each from its own prefill of its prompts."""
        segment = models.make_generator(info, steps=steps)
        starts = []
        for e, prompts in zip(engines, groups):
            e.reset_state()
            first, gen = e._gen_prefill(prompts, 0.0, 0, 0.0, 0)
            starts.append((e.state, first, gen))

        def run():
            return [segment(e.params, st, first, gen)[0]
                    for e, (st, first, gen) in zip(engines, starts)]

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = profile(torch, run, steps)[0]
        return wall, busy

    def pool_phase(tag, spec, info, params):
        """Phase (b): ``EnginePool(num_lanes=POOL_LANES)``: groups of 16,
        dense decode by default, one params object and one dense copy; its
        decode counted (one whole-stack launch an engine a step); its tokens
        against two standalone Engines of 16 lanes; decode tok/s and device
        µs a step of the pool and of one B=16 Engine, dense and quantized
        (dense_logits holds the two against each other)."""
        L = info.num_layer
        prompts, _ = pool_prompts()
        dense_bytes = models.dense_cache_bytes(params)
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pool = runtime.EnginePool(info, params, POOL_LANES, token_chunk_size=ENGINE_CHUNK,
                                  device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - m0
        held = torch.cuda.memory_allocated() - m0
        dense_slot = l7.descriptor(l7.FORM_DENSE, 0, 0)
        log(f"{tag} pool: {POOL_LANES} lanes in groups {pool.group_sizes}, built in "
            f"{t_build:.2f} s; dense_cache_bytes {dense_bytes}; during construction the card "
            f"held at most {peak} bytes more than before ({peak / dense_bytes:.3f} x one dense "
            f"copy), {held} after ({held / dense_bytes:.3f} x)")
        if (pool.group_sizes != [16, 16] or pool.params_quantized is not params
                or any(e.params is not pool.params for e in pool.engines)
                or set(pool.params["mega7"]["forms"].values()) != {dense_slot}):
            raise AssertionError(f"{tag}: the pool is not two engines of 16 lanes over one "
                                 "dense params object")
        if not (dense_bytes <= held and peak < 2 * dense_bytes):
            raise AssertionError(f"{tag}: the pool's construction held more than one dense copy")
        # counted: each engine's prefill (one chunk on the dense params: the
        # WKV scan only) and one segment of 32 steps, one layer_scan7 launch
        # an engine a step (the head is dense)
        pool_layers = layer_params(pool.params, L)
        want = collections.Counter()
        for i, g in enumerate(pool.group_sizes):
            lens = [len(p) for p in prompts[16 * i:16 * i + g]]
            for T in engine_plans(runtime, _bucket, lens, ENGINE_CHUNK):
                want += expected_chunk(WKV7_CHUNKED_MIN_T, spec, pool_layers, g, T)
        want["layer_scan7"] += len(pool.engines) * (POOL_TOKENS - 1)
        got = counted(f"{tag} pool generate ({POOL_LANES} lanes)", want,
                      lambda: pool.generate(prompts, POOL_TOKENS))
        alone = [runtime.Engine(info, params, num_batch=16, token_chunk_size=ENGINE_CHUNK,
                                decode_dense=True, device="cuda") for _ in range(2)]
        want_toks = [t for i, e in enumerate(alone)
                     for t in e.generate(prompts[16 * i:16 * (i + 1)], POOL_TOKENS, seed=i)]
        if got != want_toks:
            bad = [b for b, (a, w) in enumerate(zip(got, want_toks)) if a != w]
            raise AssertionError(f"{tag}: pool lanes {bad} differ from standalone engines")
        log(f"{tag} pool tokens equal two standalone Engine(num_batch=16, decode_dense=True) "
            f"lane for lane ({POOL_LANES} x {POOL_TOKENS}); lane 0 {got[0][:8]}...")
        quant = runtime.Engine(info, params, num_batch=16, token_chunk_size=ENGINE_CHUNK,
                               decode_dense=False, prefill_dense=False, device="cuda")
        steps = 64
        for label, engines in (("pool", pool.engines), ("one B=16 Engine (dense)", alone[:1]),
                               ("one B=16 Engine (quantized)", [quant])):
            lanes = 16 * len(engines)
            t, dev = decode_segments(info, engines, [prompts[16 * i:16 * (i + 1)]
                                                     for i in range(len(engines))], steps)
            dev_s = "not measured" if dev is None else f"{dev:.1f} device us/step"
            log(f"{tag} {label} decode: {lanes * steps / t:.2f} tok/s ({t / steps * 1e3:.3f} "
                f"ms/step over {steps} steps, {lanes} lanes), {dev_s}, on {smi}")
        # the dense slot against the quantized one from the same state: one
        # decode step of the 16 lanes at full depth (logged; held on the
        # card-vs-CPU model's two layers by dense_logits)
        err = rel_err(*decode_step(quant, [alone[0], quant], prompts[:16]))
        log(f"{tag} B=16 one decode step from the same state, dense against quantized, "
            f"L={L}: max|d-q|/max|q| {err:.3e} (not held here)")
        del pool, alone, quant

    def decode_step(source, engines, prompts):
        """Each engine's logits of one decode step of every lane from the
        same state: ``source``'s after ``prompts``."""
        last_logits(source, prompts)
        state = clone_tree(source.state)
        _, step = pool_prompts()
        out = []
        for e in engines:
            e.state = clone_tree(state)
            out.append(last_logits_continue(e, step))
        return out

    def pool_prompts():
        """The pool's prompts (POOL_LANES of 8-47 tokens) and one decode
        token for each of the first 16 lanes, from POOL_SEED."""
        prng = np.random.default_rng(POOL_SEED)
        prompts = [[int(t) for t in prng.integers(0, VOCAB, int(n))]
                   for n in prng.integers(8, 48, POOL_LANES)]
        return prompts, [[int(t)] for t in prng.integers(0, VOCAB, 16)]

    def last_logits_continue(eng, tokens):
        """One more chunk (``tokens`` a lane) after ``last_logits``: each
        lane's logits."""
        inp = runtime.RnnInput([runtime.RnnInputBatch(list(t)) for t in tokens], ENGINE_CHUNK)
        return np.stack([o[-1] for o in eng.infer(inp)])

    def state_file_phase(tag, info, eng):
        """Phase (c): one lane's state through ``back_state`` →
        ``save_state`` → ``load_state`` into the lane after a reset: three
        more tokens on that lane give the same logits and state bit for bit
        as before the reset."""
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/lane.npz"
            snap = eng.back_state(1)
            rio.save_state(path, info, snap)
            ref = rio.state_to_reference_layout(info, snap)

            def cont():
                inp = runtime.RnnInput([runtime.RnnInputBatch([]) for _ in range(4)],
                                       ENGINE_CHUNK)
                out = []
                for t in STATE_TOKENS:
                    inp.batches[1].push(t)
                    out.append(eng.infer(inp)[1])
                return np.concatenate(out), eng.back_state(1)

            before, st_before = cont()
            eng.reset_state(1)
            fresh = models.init_state(info, 1, device="cpu")
            if any(not np.array_equal(eng.back_state(1)[k], fresh[k][:, 0].numpy())
                   for k in fresh):
                raise AssertionError(f"{tag}: reset_state did not reset the lane")
            loaded = rio.load_state(path)
            eng.load_state(1, loaded)
            after, st_after = cont()
            same = np.array_equal(before, after) and all(
                np.array_equal(st_before[k], st_after[k]) for k in st_before)
            log(f"{tag} state file: lane 1 ({os.path.getsize(path)} bytes, reference layout "
                f"{list(ref.shape)}) saved, the lane reset and loaded back: {len(STATE_TOKENS)} "
                f"more tokens give {'the same' if same else 'OTHER'} logits and state bit for "
                f"bit")
            if not same or sorted(loaded) != sorted(snap):
                raise AssertionError(f"{tag}: the lane did not continue from its state file")

    def initial_state_phase(tag, info, params):
        """Phase (c): a file's time_state (``load_initial_state``) as every
        lane's initial WKV state: each lane, and a reset lane after a prompt,
        holds the file's state bit for bit."""
        H, hs = info.num_head, info.head_size
        srng = np.random.default_rng(POOL_SEED)
        w = GgufWriter()
        w.add_metadata("rwkv7.wkv.head_size", hs)
        for i in range(info.num_layer):
            w.add_tensor(f"blk.{i}.attn_time_state",
                         srng.normal(size=(info.num_emb, hs)).astype(np.float32) * 0.1)
        wkv = models.load_initial_state(GgufFile(w.tobytes()), info)
        e = runtime.Engine(info, params, num_batch=4, token_chunk_size=ENGINE_CHUNK,
                           initial_wkv=wkv, device="cuda")
        ok = all(np.array_equal(e.back_state(b)["wkv"], wkv) for b in range(4))
        lg = last_logits(e, engine_prompts)  # from a reset: the file's state again
        moved = not np.array_equal(e.back_state(2)["wkv"], wkv)
        e.reset_state(2)
        ok = ok and moved and np.array_equal(e.back_state(2)["wkv"], wkv) and bool(
            np.isfinite(lg).all())
        log(f"{tag} initial state: load_initial_state {list(wkv.shape)} from a file's "
            f"time_state; every lane and a reset lane hold it bit for bit: {ok}")
        if not ok:
            raise AssertionError(f"{tag}: Engine(initial_wkv=) did not start from the file")

    def same_params(a, b, path="params"):
        """Paths where two parameter trees differ (values, dtype, shape)."""
        if isinstance(a, dict):
            if set(a) != set(b):
                return [path]
            return [d for k in a for d in same_params(a[k], b[k], f"{path}.{k}")]
        if isinstance(a, list):
            if len(a) != len(b):
                return [path]
            return [d for i, (x, y) in enumerate(zip(a, b))
                    for d in same_params(x, y, f"{path}[{i}]")]
        if isinstance(a, Matrix):
            if (a.kind, a.shape) != (b.kind, b.shape):
                return [path]
            return same_params(a.arrays, b.arrays, path)
        ok = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        return [] if ok else [path]

    def snapshot_phase(tag, info, params, t_load):
        """Phase (c): a snapshot of a requantized model reloads with no
        requantization; params and Engine logits bit for bit."""
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/model.rwkvz"
            t0 = time.perf_counter()
            rio.save_model(path, info, params)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            info2, p2 = rio.load_model_snapshot(path, device="cuda")
            torch.cuda.synchronize()
            t_snap = time.perf_counter() - t0
            size = os.path.getsize(path)
        diff = same_params(p2, params)
        lg = [last_logits(runtime.Engine(i, p, num_batch=len(ENGINE_LENGTHS),
                                         token_chunk_size=ENGINE_CHUNK, device="cuda"),
                          engine_prompts) for i, p in ((info, params), (info2, p2))]
        same = np.array_equal(*lg)
        log(f"{tag} snapshot: {size / 1e6:.1f} MB written in {t_save:.2f} s; load_model_snapshot "
            f"on cuda {t_snap:.2f} s against load_model with requantization {t_load:.2f} s; "
            f"arrays differing: {diff or 'none'}; Engine logits bit for bit: {same}")
        if diff or not same or info2 != info:
            raise AssertionError(f"{tag}: the snapshot did not give the model back")

    def safetensors_phase(tag, info, params, raw):
        """Phase (c): the model written as a model-convention .safetensors file
        (each tensor in its stored type) loads with load_model(SafetensorsFile)
        to the GGUF load's params and Engine logits, bit for bit."""
        g = GgufFile(raw)
        tensors = model_convention(g)
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/model.st"
            rio.write_safetensors(path, tensors)
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            info2, p2 = models.load_model(rio.SafetensorsFile(path), device="cuda")
            torch.cuda.synchronize()
            t_st = time.perf_counter() - t0
        diff = same_params(p2, params)
        lg = [last_logits(runtime.Engine(i, p, num_batch=len(ENGINE_LENGTHS),
                                         token_chunk_size=ENGINE_CHUNK, device="cuda"),
                          engine_prompts) for i, p in ((info, params), (info2, p2))]
        same = np.array_equal(*lg)
        log(f"{tag} safetensors: {len(tensors)} tensors, {size / 1e6:.1f} MB; "
            f"load_model(SafetensorsFile) on cuda {t_st:.2f} s; arrays differing: "
            f"{diff or 'none'}; Engine logits bit for bit: {same}")
        if diff or not same or info2 != info:
            raise AssertionError(f"{tag}: the safetensors file did not give the model back")


    def drive(tag, spec, info, params):
        """The main paths of one model: two requests at B=1 on the loaded
        params (the per-layer kernels; for a "grouped" RWKV-7 model on
        ``models.unroll_params(params)``, whose r, k and v take the grouped
        gemv), then the Engine at B=4 (chunked prefill, decode through the
        whole-stack kernel, one FULL infer), timed and profiled; then the
        whole-stack kernel against its plain version on the Engine's
        lanes."""
        L = info.num_layer
        layers = layer_params(params, L)
        mega_key, scan_name = spec["mega"] or (None, None)
        serve_params = models.unroll_params(params) if spec.get("grouped") else params
        serve_layers = layer_params(serve_params, L)
        if spec.get("grouped") and not all("Wrkv_g" in blk["att"] for blk in serve_layers):
            raise AssertionError(f"{tag}: unroll_params did not group every layer's r, k, v")

        def chunk(B, T, layers=layers):
            return expected_chunk(WKV7_CHUNKED_MIN_T, spec, layers, B, T)

        def head(n):
            kernel = matmul_kernel(params["head"], n)
            return collections.Counter({kernel: 1} if kernel else {})

        # ---- main path: two requests at batch 1 ----------------------------
        want = collections.Counter()
        for prompt in PROMPTS:
            want += chunk(1, len(prompt), serve_layers) + head(1)
            for _ in range(DECODE_STEPS):
                want += chunk(1, 1, serve_layers) + head(1)
        form = "unrolled params" if spec.get("grouped") else "loaded params"
        tokens1, t_prompt, t_gen = counted(
            f"{tag} serve (B=1, {form})", want,
            lambda: serve(torch, models, info, serve_params, PROMPTS, DECODE_STEPS))
        tokens2, t_prompt2, t_gen2 = serve(torch, models, info, serve_params, PROMPTS,
                                           DECODE_STEPS)
        if tokens1 != tokens2:
            raise AssertionError(f"{tag}: greedy tokens differ between two runs")
        if not all(0 <= t < info.num_vocab for req in tokens1 for t in req):
            raise AssertionError(f"{tag}: token out of range")
        n_dec = len(PROMPTS) * DECODE_STEPS
        n_prompt = sum(len(p) for p in PROMPTS)
        log(f"{tag} requests: {len(PROMPTS)} x ({len(PROMPTS[0])} prompt tokens in one chunk "
            f"+ 1 + {DECODE_STEPS} greedy); tokens identical across two runs; first request "
            f"{tokens1[0][:8]}...")
        log(f"{tag} eager decode at B=1: {n_dec / t_gen2:.2f} tok/s "
            f"({t_gen2 / n_dec * 1e3:.3f} ms/token; first run {n_dec / t_gen:.2f} tok/s), "
            f"prompt prefill {t_prompt2 / n_prompt * 1e3:.3f} ms/prompt token (one chunk of "
            f"{len(PROMPTS[0])}), on {smi}")
        dstate = models.init_state(info, 1, device="cuda")
        gen8 = models.make_generator(info, steps=8)
        busy, prof_wall_us, rows = profile(
            torch, lambda: gen8(serve_params, dstate, torch.tensor([[1]], device="cuda")), 8)
        log_profile(f"{tag} 8 decode steps at B=1", busy, prof_wall_us, rows,
                    t_gen2 / n_dec * 1e6, "token")

        # ---- main path: the Engine at B=4 ----------------------------------
        # under the default dense-prefill policy (or the model's "engine"
        # arguments): chunks from prefill_dense_min_t tokens on run on the
        # dense bf16 copy, the head included where every lane asks for its
        # last row
        B4 = len(ENGINE_LENGTHS)
        eng_kw = spec.get("engine", {})
        eng = runtime.Engine(info, params, num_batch=B4, token_chunk_size=ENGINE_CHUNK,
                             device="cuda", **eng_kw)
        dense_bytes = models.dense_cache_bytes(params)
        free, total = torch.cuda.mem_get_info()
        dense_on = eng_kw.get("prefill_dense", runtime.auto_prefill_dense(dense_bytes, total))
        log(f"{tag} engine dense prefill policy: dense_cache_bytes {dense_bytes} "
            f"({dense_bytes / 1e9:.3f} GB); mem_get_info free {free}, total {total} bytes; "
            f"2.3 x extra < 0.6 x total: {2.3 * dense_bytes < 0.6 * total}; prefill_dense "
            f"{eng_kw.get('prefill_dense', 'default')} -> {dense_on}, chunks of T >= "
            f"{eng._prefill_min_t} on the dense copy")
        if (eng._params_prefill is not None) != dense_on:
            raise AssertionError(f"{tag}: the Engine's dense prefill copy is not what its "
                                 "policy says")
        dense_layers = layer_params(eng._params_prefill, L) if dense_on else None

        def on_dense(T):
            return dense_on and T >= eng._prefill_min_t

        Ts = engine_plans(runtime, _bucket, ENGINE_LENGTHS, ENGINE_CHUNK)
        decode_steps = -(-(ENGINE_TOKENS - 1) // 32) * 32  # whole 32-token segments
        want = collections.Counter()
        for T in Ts:  # an all-LAST chunk's head: from the chunk's own params
            want += (chunk(B4, T, dense_layers) if on_dense(T) else chunk(B4, T) + head(B4))
        if (mega_key in eng.params) != (mega_key is not None) or (
                mega_key is None and {"mega7", "mega56"} & set(eng.params)):
            raise AssertionError(f"{tag}: the Engine arranged whole-stack blocks "
                                 f"{sorted({'mega7', 'mega56'} & set(eng.params))}, expected "
                                 f"{mega_key}")
        # each step: one whole-stack launch, or the per-layer path at T=1; the head
        step = (collections.Counter({scan_name: 1}) if mega_key else chunk(B4, 1)) + head(B4)
        for _ in range(decode_steps):
            want += step
        log(f"{tag} engine: prompts of {list(ENGINE_LENGTHS)} tokens, prefill chunks T={Ts} "
            f"(token_chunk_size {ENGINE_CHUNK}; on the dense copy: "
            f"{[T for T in Ts if on_dense(T)]}), then {decode_steps} decode steps at B={B4}, "
            f"each {dict(step)} (the head: {matmul_kernel(params['head'], B4) or 'dense'} "
            f"at n={B4})")
        out_gen = counted(f"{tag} engine generate (B=4)", want,
                          lambda: eng.generate(engine_prompts, ENGINE_TOKENS))
        if [len(o) for o in out_gen] != [ENGINE_TOKENS] * B4 or not all(
                0 <= t < info.num_vocab for o in out_gen for t in o):
            raise AssertionError(f"{tag}: engine generate returned "
                                 f"{[len(o) for o in out_gen]} tokens")

        T_full = _bucket(max(p.len for p in full_plan), ENGINE_CHUNK)
        # a FULL chunk's head runs on the Engine's own params, as the JAX Engine's
        want = chunk(B4, T_full, dense_layers if on_dense(T_full) else layers) + head(full_rows)
        inp = runtime.RnnInput([runtime.RnnInputBatch(list(b.tokens), b.option)
                                for b in full_inp.batches], ENGINE_CHUNK)
        out_full = counted(f"{tag} engine infer with a FULL lane", want, lambda: eng.infer(inp))
        shapes = [tuple(o.shape) for o in out_full]
        want_shapes = [((p.len if p.option == runtime.RnnOption.FULL else int(p.len > 0)),
                        info.num_vocab) for p in full_plan]
        if shapes != want_shapes or not all(np.isfinite(o).all() for o in out_full):
            raise AssertionError(f"{tag}: FULL infer returned {shapes}, expected {want_shapes}")
        log(f"{tag} engine infer: lanes {[(n, o) for n, o in FULL_LANES]} in one chunk "
            f"T={T_full}; logits {shapes}, head at {full_rows} rows")

        # timing: prefill alone (generate of one token), then prefill + 32 steps
        def run_generate(n_tokens):
            eng.reset_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.generate(engine_prompts, n_tokens)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        _, t_pre = run_generate(1)
        out_t, _ = run_generate(1 + decode_steps)
        if [o[:ENGINE_TOKENS] for o in out_t] != out_gen:
            raise AssertionError(f"{tag}: engine greedy tokens differ between two runs")
        # decode alone: the Engine's own prefill, then the decode segment that
        # generate runs (make_generator on the Engine's prepared params), timed
        eng.reset_state()
        first, gen = eng._gen_prefill(engine_prompts, 0.0, 0, 0.0, 0)
        segment = models.make_generator(info, steps=decode_steps)
        pre_state = eng.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _, _, _, _ = segment(eng.params, pre_state, first, gen)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        if [o[1:1 + decode_steps] for o in out_t] != toks.tolist():
            raise AssertionError(f"{tag}: the timed decode segment gave other tokens than "
                                 "generate")
        n_pre = sum(ENGINE_LENGTHS)
        log(f"{tag} engine prefill: {n_pre / t_pre:.2f} tok/s ({n_pre} prompt tokens in "
            f"{t_pre * 1e3:.1f} ms, {t_pre / n_pre * 1e3:.3f} ms/prompt token), on {smi}")
        log(f"{tag} engine decode at B={B4}: {B4 * decode_steps / t_dec:.2f} tok/s "
            f"({t_dec / decode_steps * 1e3:.3f} ms/step, {decode_steps} steps timed alone), "
            f"on {smi}")
        busy_pre, prof_wall_us, rows = profile(
            torch, lambda: (eng.reset_state(), eng.generate(engine_prompts, 1)), n_pre)
        log_profile(f"{tag} engine prefill of {n_pre} prompt tokens", busy_pre, prof_wall_us,
                    rows, t_pre / n_pre * 1e6, "prompt token")
        if busy_pre is not None:  # the dequant-GEMM's part (every instantiation)
            gemm_us = sum(us for us, key, _ in rows if "qk_gemm_kernel" in key)
            log(f"{tag} engine prefill: qk_gemm_kernel {gemm_us:.2f} us/prompt token, "
                f"{gemm_us / busy_pre:.3f} of the prefill's device time")
        held_state = clone_tree(eng.state)  # what the whole-stack check below starts from
        t_phases = time.perf_counter()
        if spec.get("dense_compare"):
            dense_against_quantized(tag, info, params, eng, busy_pre, n_pre, t_pre)
        if spec.get("dense8"):
            decode_dense8(tag, spec, info, params)
        if spec.get("pool"):
            pool_phase(tag, spec, info, params)
        if spec.get("state_file"):
            state_file_phase(tag, info, eng)
        if spec.get("initial_state"):
            initial_state_phase(tag, info, params)
        eng.state = held_state
        log(f"{tag} serving and file phases: {time.perf_counter() - t_phases:.1f} s")
        busy, prof_wall_us, rows = profile(
            torch, lambda: segment(eng.params, pre_state, first, None), decode_steps)
        log_profile(f"{tag} engine decode at B={B4}", busy, prof_wall_us, rows,
                    t_dec / decode_steps * 1e6, "step")

        if mega_key is None:
            return
        # ---- the whole-stack decode kernel against its plain version --------
        # on the Engine's lanes as generate left them, one lane frozen, at
        # each of the model's batches (lanes repeated)
        dec_x = models.embed_tokens(params, torch.tensor([[o[-1]] for o in out_gen],
                                                         device="cuda"))[:, 0]
        hold_stack(tag, mega_key, eng.params[mega_key], eng.state, dec_x, spec["mega_batches"])

    @contextlib.contextmanager
    def capture_gemms(calls, on):
        """While ``on``: each dequant-GEMM call with group offsets that
        ``Matrix.matmul`` makes (``q4k_gemm``, ``qkb_gemm``; ``qs_gemm``
        with mins, the Int8 form among them) lands in ``calls`` as (wrapper
        name, its arguments), then runs."""
        saved = {name: getattr(matrix_mod, name) for name in ("q4k_gemm", "qkb_gemm", "qs_gemm")}

        def recorder(name, fn):
            def record(*args):
                if name != "qs_gemm" or args[3] is not None:
                    calls.append((name, args))
                return fn(*args)
            return record

        if on:
            for name, fn in saved.items():
                setattr(matrix_mod, name, recorder(name, fn))
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(matrix_mod, name, fn)

    def gemm_terms(name, args):
        """A dequant-GEMM call's function in f64 (the same bf16 operands):
        its products' sum, its offset term and their difference y, and how
        many times max|y| the offset term's magnitude Σ_g|mn·xs| reaches."""
        x, codes, *factors = args
        m, k = codes.shape[0], x.shape[-1]
        if name == "qs_gemm":
            s, mn = factors
        else:
            s, mn = mm.q4k_scale_products(*factors)
        g = s.shape[-1]
        q = mm.qs_codes(codes, k)
        w = (q.view(m, g, k // g) * s[..., None]).to(torch.bfloat16).double()
        xb = x.to(torch.bfloat16).double()
        main = xb @ w.view(m, k).T
        xs = xb.view(-1, g, k // g).sum(-1)
        y = main - xs @ mn.double().T
        return main, y, ((xs.abs() @ mn.double().abs().T).max() / y.abs().max()).item()

    def activation_case(tag, calls):
        """The captured GEMM calls against their plain versions on the
        model's own activations; the one furthest from its plain version
        becomes a kernel case (held at GEMM_TOL, timed, in the JSON line),
        its error and its plain version's split against the f64 function:
        the whole product, and its products' sum alone (offsets zeroed)."""
        worst = None
        for name, args in calls:
            err, lim = gemm_compare(getattr(mm, name)(*args), getattr(mm, f"{name}_plain")(*args))
            if worst is None or err / lim > worst[0]:
                worst = (err / lim, name, args)
        share, name, args = worst
        kernel, plain = getattr(mm, name), getattr(mm, f"{name}_plain")
        x, codes = args[:2]
        (n, k), m = x.shape, codes.shape[0]
        main, y, cancel = gemm_terms(name, args)
        bare = (*args[:3], None) if name == "qs_gemm" else (*args[:3], torch.zeros_like(args[3]),
                                                             *args[4:])
        rel = lambda a, b: ((a.double() - b).abs().max() / y.abs().max()).item()  # noqa: E731
        log(f"  {tag}: {len(calls)} dequant-GEMM calls with offsets in the decode steps, on "
            f"the model's own activations; the furthest from its plain version {name} "
            f"[n={n}, m={m}, k={k}] at {share:.3f} of its tolerance. Against its function in "
            f"f64, × max|y|: kernel {rel(kernel(*args), y):.3e}, plain "
            f"{rel(plain(*args), y):.3e}; "
            f"the products' sum alone: kernel {rel(kernel(*bare), main):.3e}, plain "
            f"{rel(plain(*bare), main):.3e}; the offset term's magnitude is {cancel:.1f} "
            f"× max|y|")

        def make(i):
            return args if i == 0 else tuple(a if a is None else a.clone() for a in args)

        def weight(a):
            if name == "qs_gemm":
                w = mm.qs_dequantize(a[1], a[2], a[3], k=k)
            else:
                w = getattr(mm, name.replace("gemm", "dequantize"))(*a[1:])
            return a[0].to(torch.bfloat16), w.to(torch.bfloat16).T

        case = dict(name=f"{name}[{tag} activations,m={m},k={k},n={n}]", kernel=kernel,
                    plain=plain, shape=(n, m, k), make_args=make, compare=gemm_compare,
                    nbytes=sum(a.numel() * a.element_size() for a in args[1:] if a is not None)
                    + 2 * n * k + 4 * n * m,
                    flops=2 * n * m * k, fpeak=bf16_peak, library=torch.matmul,
                    library_args=weight)
        add_entry(case, run_kernel_case(torch, case, hbm))
        cases.append(case)

    def card_vs_cpu(tag, spec, info2, p_gpu, p_cpu):
        """The card against the CPU, same widths, two layers, three lanes."""
        decode = [(np.array(toks)[:, None], np.array(lens)) for toks, lens in COMPARE_STEPS]
        prng = np.random.default_rng(COMPARE_SEED)
        prefill = [(prng.integers(0, VOCAB, (len(lens), T)), np.array(lens))
                   for T, lens in COMPARE_PREFILL]
        batch = len(COMPARE_STEPS[0][1])
        runs = [("decode steps, per-layer kernels (lane 2 frozen on the second)", decode,
                 p_gpu, p_cpu)]
        if spec["mega"] is not None:
            mega_key = spec["mega"][0]
            m_gpu = models.prepare_decode(p_gpu, info2, batch)
            m_cpu = models.prepare_decode(p_cpu, info2, batch)
            if mega_key not in m_gpu or mega_key not in m_cpu:
                raise AssertionError(f"{tag}: the compare model did not take the whole-stack "
                                     "decode blocks")
            runs.append(("decode steps, whole-stack kernel (lane 2 frozen on the second)",
                         decode, m_gpu, m_cpu))
        runs.append((f"prefill chunks {COMPARE_PREFILL}", prefill, p_gpu, p_cpu))
        fmt = lambda rel: ", ".join(f"{k} {v:.3e}" for k, v in rel.items())  # noqa: E731
        failed = []  # every comparison runs and prints before a failure raises
        for label, chunks, pg, pc in runs:
            gemms = []  # the decode steps' dequant-GEMM calls with offsets, on the card
            with capture_gemms(gemms, chunks is decode and pg is p_gpu):
                card = run_chunks(torch, models, info2, pg, chunks, "cuda")
            if gemms:
                activation_case(tag, gemms)
            cpu = run_chunks(torch, models, info2, pc, chunks, "cpu")
            per_chunk = rel_diff(card, cpu)
            log(f"{tag} card vs CPU, L={COMPARE_LAYERS}, B={batch}, {label}: max "
                f"|card-cpu|/max|cpu| per chunk (tolerance {CARD_CPU_TOL}; WKV state of "
                f"later layers {CARD_CPU_WKV_TOL}):")
            for i, rel in enumerate(per_chunk):
                log(f"  chunk {i}: {fmt(rel)}")
            if pg is p_gpu:  # the evidence for the limits, from this run
                log(f"  largest WKV state difference at (lane, head or channel) per layer: "
                    f"{wkv_max_at(card, cpu)}")
                for dev, p, clean in (("cuda", pg, card), ("cpu", pc, cpu)):
                    for seed, (rels, at) in sensitivity(torch, models, Matrix, info2, p,
                                                        chunks, dev, clean).items():
                        for i, rel in enumerate(rels):
                            log(f"  {dev} alone, one-ulp product changes, seed {seed}, "
                                f"chunk {i}: {fmt(rel)}; largest at {at[i]}")
            if chunks is prefill:  # a fault for scale: lane 1 one token short
                (toks0, lens0), *rest = prefill
                short = run_chunks(torch, models, info2, pc,
                                   [(toks0, lens0 - (np.arange(len(lens0)) == 1))] + rest, "cpu")
                for i, rel in enumerate(rel_diff(short, cpu)):
                    log(f"  a fault for scale, cpu alone, lane 1's last token of chunk 0 "
                        f"left out, chunk {i}: {fmt(rel)}")
            if not all(v <= card_cpu_limit(k) for rel in per_chunk for k, v in rel.items()):
                failed.append(label)
        if failed:
            raise AssertionError(f"{tag}: the card disagrees with the CPU ({failed})")

    # ---- the model surface: hooks, embedding input, vision, LoRA, direct --

    def hooked_step(spec, layers, B):
        """Launches of one hooked decode step of B lanes on the per-layer
        path: the matrices as at T=1, the WKV as the scan kernel at T=1
        (the fused att-core kernel and the grouped gemv are left out)."""
        want = collections.Counter()
        for blk in layers:
            for part, name in spec["matrices"]:
                want[matmul_kernel(blk[part][name], B)] += 1
        at_1 = spec["wkv"][0]
        want["wkv7_scan" if at_1 == "att_core7_step" else at_1] += len(layers)
        return want

    def hooks_phase(tag, spec, info, params):
        """RWKV-7: observer taps on every name of HOOK_NAMES: a T=64 chunk
        of four lanes with and without them, x and state bit for bit, every
        tap fired at every layer; then the Engine at B=4 with the taps
        (the usual prompts, then HOOK_STEPS greedy steps), counted: no
        whole-stack, att-core or grouped launch, the WKV as wkv7_scan at
        T=1 a layer a step; the hooked step's device µs. Other versions:
        the Engine with the model's example hook, counted."""
        from web_rwkv_gguf_tpu_torch.models.forward import HOOK_NAMES

        t0 = time.perf_counter()
        L, B4 = info.num_layer, len(ENGINE_LENGTHS)
        v7 = info.version.value == "v7"
        fired = collections.defaultdict(list)
        taps = {n: (lambda name: lambda layer, **t: fired[name].append(layer))(n)
                for n in HOOK_NAMES[info.version]}
        hooks = taps if v7 else HOOK_EXAMPLES[spec["hooks"]](L)
        if v7:
            lens = [min(n, 64) for n in ENGINE_LENGTHS]
            toks = torch.tensor([p[:64] + [0] * (64 - len(p[:64])) for p in engine_prompts],
                                device="cuda")
            ln = torch.tensor(lens, device="cuda")
            st0 = models.init_state(info, B4, device="cuda")
            x0, s0 = models.forward_chunk(info, params, st0, toks, ln)
            x1, s1 = models.forward_chunk(info, params, st0, toks, ln, hooks=taps)
            models.logits_head(params, x1[:, -1], hooks=taps)
            same = torch.equal(x0, x1) and all(torch.equal(s0[k], s1[k]) for k in s0)
            bad = [n for n in taps if fired[n] != ([-1] if n in MODEL_TAPS else list(range(L)))]
            log(f"{tag} hooks: {len(taps)} observer taps on a T=64 chunk of lanes {lens}: x "
                f"and state {'equal' if same else 'DIFFER from'} the unhooked chunk's bit for "
                f"bit; taps that did not fire once at every layer: {bad or 'none'}")
            if not same or bad:
                raise AssertionError(f"{tag}: the hooked chunk is not the unhooked one")
        eng = runtime.Engine(info, params, num_batch=B4, token_chunk_size=ENGINE_CHUNK,
                             hooks=hooks, device="cuda")
        want = (engine_prefill(spec, eng, ENGINE_LENGTHS)
                + times(engine_step(spec, eng), HOOK_STEPS))
        fired.clear()
        label = "every tap" if v7 else f"{spec['hooks']}'s tap"
        toks = counted(f"{tag} hooks engine generate (B={B4}, {label})", want,
                       lambda: eng.generate(engine_prompts, 1 + HOOK_STEPS, segment=HOOK_STEPS))
        if [len(t) for t in toks] != [1 + HOOK_STEPS] * B4:
            raise AssertionError(f"{tag}: the hooked Engine gave {[len(t) for t in toks]}")
        if v7:
            steps = len(engine_plans(runtime, _bucket, ENGINE_LENGTHS, ENGINE_CHUNK)) + HOOK_STEPS
            bad = [n for n in taps if n not in MODEL_TAPS and fired[n] != list(range(L)) * steps]
            if bad:
                raise AssertionError(f"{tag}: taps {bad} did not fire at every layer")
        # the hooked decode step alone: device and wall µs
        eng.reset_state()
        first, gen = eng._gen_prefill(engine_prompts, 0.0, 0, 0.0, 0)
        segment = models.make_generator(info, steps=HOOK_STEPS, hooks=hooks)
        state = eng.state
        segment(eng.params, state, first, None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        segment(eng.params, state, first, None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) / HOOK_STEPS * 1e6
        busy, prof_wall_us, rows = profile(
            torch, lambda: segment(eng.params, state, first, None), HOOK_STEPS)
        log_profile(f"{tag} hooked engine decode at B={B4} ({label})", busy, prof_wall_us, rows,
                    wall_us, "step")
        log(f"{tag} hooks phase: {time.perf_counter() - t0:.1f} s")

    def embeds_phase(tag, info, params):
        """Token::Embed: an Engine of four lanes, EMBED_TOKENS tokens each:
        lane 0 token ids, lane 1 the same tokens as their embedding rows,
        lane 2 ids and rows in turn, lane 3 ids of another prompt; lanes 0
        and 1 give the same logits bit for bit, lane 2 within rounding."""
        t0 = time.perf_counter()
        ids = engine_prompts[0][:EMBED_TOKENS]
        rows = params["emb"][torch.tensor(ids, device="cuda")].float().cpu().numpy()
        lanes = [ids, list(rows), [t if i % 2 == 0 else rows[i] for i, t in enumerate(ids)],
                 engine_prompts[1][:EMBED_TOKENS]]
        eng = runtime.Engine(info, params, num_batch=len(lanes), token_chunk_size=ENGINE_CHUNK,
                             device="cuda")
        inp = runtime.RnnInput([runtime.RnnInputBatch(list(t)) for t in lanes], ENGINE_CHUNK)
        last = [None] * len(lanes)
        while inp.num_token:
            for b, o in enumerate(eng.infer(inp)):
                if len(o):
                    last[b] = o[-1]
        same = np.array_equal(last[0], last[1])
        finite = all(np.isfinite(o).all() for o in last)
        log(f"{tag} embeds: lanes of {EMBED_TOKENS} ids / rows / mixed / ids through "
            f"Engine.infer (chunk T={_bucket(EMBED_TOKENS, ENGINE_CHUNK)}, dense prefill copy "
            f"{eng._params_prefill is not None}): lane 1 (rows) against lane 0 (ids) "
            f"{'equal' if same else 'DIFFERENT'} bit for bit; lane 2 (mixed) "
            f"max|d|/max {rel_err(last[2], last[0]):.3e}; finite {finite}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not same or not finite:
            raise AssertionError(f"{tag}: embedding rows did not give the ids' logits")

    def vision_patches():
        return (np.random.default_rng(VISION_SEED).normal(size=(16, 16, 3, 64))
                .astype(np.float32))

    def vision_phase(tag, info, params):
        """infer_vision at full depth: patches [16, 16, 3, 64] as one T=64
        chunk of input embeddings, counted; the embedding finite."""
        t0 = time.perf_counter()
        layers = layer_params(params, info.num_layer)
        want = expected_chunk(WKV7_CHUNKED_MIN_T, MODELS[tag], layers, 1, 64)
        emb, st = counted(f"{tag} vision (infer_vision, 64 patches)", want,
                          lambda: runtime.infer_vision(info, params,
                                                       runtime.VisionInput(vision_patches())))
        ok = emb.shape == (info.num_emb,) and bool(np.isfinite(emb).all())
        log(f"{tag} vision: embedding {emb.shape}, finite {ok}, max|emb| "
            f"{np.abs(emb).max():.4g}; {time.perf_counter() - t0:.1f} s")
        if not ok:
            raise AssertionError(f"{tag}: infer_vision gave no finite embedding")

    def held_against_cpu(tag, label, card, cpu):
        """Per chunk, the card's results against the CPU's at
        card_cpu_limit; logged, raised past it."""
        per_chunk = rel_diff(card, cpu)
        worst, at, key = max((v / card_cpu_limit(k), i, k)
                             for i, rel in enumerate(per_chunk) for k, v in rel.items())
        fmt = ", ".join(f"{k} {v:.3e}" for k, v in per_chunk[at].items())
        log(f"{tag} {label}, card vs CPU, L={COMPARE_LAYERS}: worst share of the limit "
            f"{worst:.3f} ({key}, chunk {at}: {fmt})")
        if not worst <= 1.0:
            raise AssertionError(f"{tag}: {label}: the card disagrees with the CPU")

    def held_sequences(tag, label, info2, pg, pc, hooks=None):
        """card_vs_cpu's two sequences, each from a zero state, on the card
        and on the CPU: the decode steps (COMPARE_STEPS) and the first
        prefill chunk (COMPARE_PREFILL); each held by held_against_cpu."""
        prng = np.random.default_rng(COMPARE_SEED)
        T, lens = COMPARE_PREFILL[0]
        for what, chunks in (
                ("decode steps", [(np.array(t)[:, None], np.array(n)) for t, n in COMPARE_STEPS]),
                (f"prefill T={T}", [(prng.integers(0, VOCAB, (len(lens), T)), np.array(lens))])):
            held_against_cpu(tag, f"{label}, {what}",
                             run_chunks(torch, models, info2, pg, chunks, "cuda", hooks),
                             run_chunks(torch, models, info2, pc, chunks, "cpu", hooks))

    def surface_vs_cpu(tag, spec, raw2, info2, p_gpu, p_cpu):
        """The compare model (COMPARE_LAYERS layers, full widths) on the card
        against the CPU: the example hooks and a LoRA merged at load (dense
        and NF4) on card_vs_cpu's decode steps and prefill chunk, each from
        a zero state (chained, prefill then decode, V6 puzzle15's first step
        carries the prefill's state past the limit with PyTorch's own ops on
        the card as with the kernels: scripts/torch_trace_compare.py --hooks
        puzzle15 --prefill; PERF.md, Findings), the vision chunk, and
        the file loaded with allow_quantized_direct=False (one prefill,
        counted)."""
        from web_rwkv_gguf_tpu_torch.models.loader import _walk_matrices
        from web_rwkv_gguf_tpu_torch.quant import QuantScheme

        t0 = time.perf_counter()
        prng = np.random.default_rng(COMPARE_SEED)
        T, lens = COMPARE_PREFILL[0]
        prefill = [(prng.integers(0, VOCAB, (len(lens), T)), np.array(lens))]
        if spec.get("hooks"):
            held_sequences(tag, f"{spec['hooks']} hooks", info2, p_gpu, p_cpu,
                           HOOK_EXAMPLES[spec["hooks"]](info2.num_layer))
        if spec.get("vision"):
            out = []
            for p in (p_gpu, p_cpu):
                emb, st = runtime.infer_vision(info2, p, runtime.VisionInput(vision_patches()))
                out.append([{"x": torch.from_numpy(emb), **{k: v.cpu() for k, v in st.items()}}])
            held_against_cpu(tag, "vision (infer_vision, 64 patches)", *out)
        if spec.get("direct"):
            direct = [models.load_model(GgufFile(raw2, allow_quantized_direct=False), device=d)
                      for d in ("cuda", "cpu")]
            (info_d, pg), (_, pc) = direct
            mats = [m for m in _walk_matrices([pg["head"], pg["blocks"]]) if m.kind != "dense"]
            if mats:
                raise AssertionError(f"{tag}: allow_quantized_direct=False loaded "
                                     f"{len(mats)} quantized matrices")
            want = expected_chunk(WKV7_CHUNKED_MIN_T, spec, layer_params(pg, info_d.num_layer),
                                  len(lens), T)
            card = counted(f"{tag} direct (allow_quantized_direct=False, dense, prefill T={T})",
                           want, lambda: run_chunks(torch, models, info_d, pg, prefill, "cuda"))
            held_against_cpu(tag, "allow_quantized_direct=False, every matrix dense, prefill",
                             card, run_chunks(torch, models, info_d, pc, prefill, "cpu"))
        if spec.get("lora"):
            reader = GgufFile(raw2)
            with tempfile.TemporaryDirectory() as tmp:
                path = f"{tmp}/lora.st"
                rio.write_safetensors(path, lora_tensors(reader, info2.num_layer, LORA_MATRICES,
                                                         LORA_SEED + 1))
                blend = models.LoraPatch.blend_matrices(LORA_ALPHA) + [LORA_VECTOR]
                for quant in (None, QuantScheme.NF4):
                    loaded = [models.load_model(GgufFile(raw2), quant=quant, device=d,
                                                lora=[models.LoraPatch(
                                                    rio.SafetensorsFile(path), blend)])
                              for d in ("cuda", "cpu")]
                    (info_l, pg), (_, pc) = loaded
                    held_sequences(tag, f"LoRA rank {LORA_RANK} on every layer matrix, "
                                        f"{quant.name if quant else 'dense'}", info_l, pg, pc)
        log(f"{tag} surface against the CPU: {time.perf_counter() - t0:.1f} s")

    def lora_phase(tag, spec, info, raw):
        """LoRA merged at load at full depth: a rank-LORA_RANK pair on every
        layer matrix and LORA_VECTOR, loaded (a) with no scheme: dense bf16
        weights equal to numpy's merge through the f16 round trip, decoded
        at B=4 by the Engine in layer7.cu's dense slot (counted); (b) with
        quant=NF4: NF4 matrices equal to the NF4 of numpy's merge."""
        from web_rwkv_gguf_tpu_torch.quant import QuantScheme

        t0 = time.perf_counter()
        reader = GgufFile(raw)
        tensors = lora_tensors(reader, info.num_layer, LORA_MATRICES, LORA_SEED)
        blend = models.LoraPatch.blend_matrices(LORA_ALPHA) + [LORA_VECTOR]
        checks = (("blocks.0.att.key.weight", 0, "att", "Wk"),
                  (f"blocks.{info.num_layer - 1}.ffn.value.weight", info.num_layer - 1,
                   "ffn", "Wv"))
        B4 = len(ENGINE_LENGTHS)
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/lora.st"
            rio.write_safetensors(path, tensors)
            for quant in (None, QuantScheme.NF4):
                _, p = models.load_model(GgufFile(raw), quant=quant, device="cuda", lora=[
                    models.LoraPatch(rio.SafetensorsFile(path), blend)])
                bad = []
                for name, i, part, key in checks:
                    a, b = tensors[f"{name}.lora.0"], tensors[f"{name}.lora.1"]
                    merged = (reader.tensor(name, np.float32)
                              + (LORA_ALPHA / LORA_RANK) * (b @ a)).astype(np.float16)
                    want = Matrix.from_f16(merged, quant or QuantScheme.NONE, torch.bfloat16,
                                           "cuda").dequantize()
                    got = p["blocks"][part][key].layer(i)
                    if got.kind != ("nf4" if quant else "dense") or not torch.equal(
                            got.dequantize(), want):
                        bad.append(name)
                vec, alpha = LORA_VECTOR
                i_v = int(vec.split(".")[1])
                v_want = alpha * tensors[vec] + (1 - alpha) * reader.tensor(vec, np.float32)
                if not np.array_equal(p["blocks"]["att"]["x_k"][i_v].cpu().numpy(), v_want):
                    bad.append(vec)
                qname = quant.name if quant else "dense"
                log(f"{tag} lora ({qname}): {len(tensors)} tensors, every layer matrix merged; "
                    f"weights against numpy's merge: {bad or 'equal'}")
                if bad:
                    raise AssertionError(f"{tag}: the LoRA merge differs from numpy's ({bad})")
                if quant is None:
                    eng = runtime.Engine(info, p, num_batch=B4, token_chunk_size=ENGINE_CHUNK,
                                         device="cuda")
                    dense_slot = l7.descriptor(l7.FORM_DENSE, 0, 0)
                    if set(eng.params["mega7"]["forms"].values()) != {dense_slot}:
                        raise AssertionError(f"{tag}: the merged model is not in the dense slot")
                    layers = layer_params(eng.params, info.num_layer)
                    want = collections.Counter()
                    for T in engine_plans(runtime, _bucket, ENGINE_LENGTHS, ENGINE_CHUNK):
                        want += expected_chunk(WKV7_CHUNKED_MIN_T, spec, layers, B4, T)
                    want["layer_scan7"] += 8
                    toks = counted(f"{tag} lora engine generate (B={B4}, dense slot)", want,
                                   lambda: eng.generate(engine_prompts, 9, segment=8))
                    if not all(len(t) == 9 for t in toks):
                        raise AssertionError(f"{tag}: the merged Engine gave {toks}")
                    del eng
                del p
                torch.cuda.empty_cache()
        log(f"{tag} lora phase: {time.perf_counter() - t0:.1f} s")

    def lora_layer0_phase(tag, spec, info, raw):
        """A LoRA on layer 0 alone of the quantized file: layer 0 loads
        dense, the others keep their blocks, so the blocks load per layer;
        one decode step of four lanes on the Engine's params (unrolled: no
        whole-stack form for mixed layers), counted."""
        t0 = time.perf_counter()
        reader = GgufFile(raw)
        tensors = lora_tensors(reader, 1, LORA_MATRICES, LORA_SEED + 2)
        del tensors[LORA_VECTOR[0]]
        B4 = len(ENGINE_LENGTHS)
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/lora.st"
            rio.write_safetensors(path, tensors)
            _, p = models.load_model(GgufFile(raw), device="cuda", lora=[models.LoraPatch(
                rio.SafetensorsFile(path), models.LoraPatch.blend_layer_matrices(0, 1.0))])
        if not isinstance(p["blocks"], list) or p["blocks"][0]["att"]["Wk"].kind != "dense":
            raise AssertionError(f"{tag}: a layer-0 LoRA did not give per-layer blocks")
        prepared = models.prepare_decode(p, info, B4)
        layers = layer_params(prepared, info.num_layer)
        want = expected_chunk(WKV7_CHUNKED_MIN_T, spec, layers, B4, 1)
        want[matmul_kernel(p["head"], B4)] += 1
        tok = torch.tensor([[o[0]] for o in engine_prompts], device="cuda")

        def step():
            x, st = models.forward_chunk(info, prepared, models.init_state(info, B4, "cuda"),
                                         tok, torch.ones(B4, dtype=torch.long, device="cuda"))
            return models.logits_head(prepared, x[:, 0])

        logits = counted(f"{tag} lora layer 0 (per-layer blocks, one decode step B={B4})",
                         want, step)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: the layer-0 LoRA step is not finite")
        log(f"{tag} lora layer 0: layer kinds "
            f"{[blk['att']['Wk'].kind for blk in p['blocks']][:3]}...; "
            f"{time.perf_counter() - t0:.1f} s")

    # ---- the apps -------------------------------------------------------------

    def times(want, n):
        return collections.Counter({k: v * n for k, v in want.items()})

    def head_of(params, n):
        kernel = matmul_kernel(params["head"], n)
        return collections.Counter({kernel: 1} if kernel else {})

    def engine_prefill(spec, eng, lengths):
        """Launches of an Engine's prefill of prompts of ``lengths``: each
        chunk on the dense copy from its least T on, else on the Engine's
        params with the head on the lanes' last rows."""
        L, B = eng.info.num_layer, eng.num_batch
        layers = layer_params(eng.params, L)
        dense = layer_params(eng._params_prefill, L) if eng._params_prefill is not None else None
        want = collections.Counter()
        for T in engine_plans(runtime, _bucket, lengths, eng.token_chunk_size):
            if dense is not None and T >= eng._prefill_min_t:
                want += expected_chunk(WKV7_CHUNKED_MIN_T, spec, dense, B, T)
            else:
                want += (expected_chunk(WKV7_CHUNKED_MIN_T, spec, layers, B, T)
                         + head_of(eng.params, B))
        return want

    def engine_step(spec, eng):
        """Launches of one decode step of an Engine's lanes: the hooked
        per-layer step where it has hooks, else the whole-stack kernel where
        its params hold one, else the per-layer path at T=1; the head."""
        B = eng.num_batch
        layers = layer_params(eng.params, eng.info.num_layer)
        if eng.hooks is not None:
            want = hooked_step(spec, layers, B)
        elif "mega7" in eng.params or "mega56" in eng.params:
            want = collections.Counter({"layer_scan7" if "mega7" in eng.params
                                        else "layer_scan56": 1})
        else:
            want = expected_chunk(WKV7_CHUNKED_MIN_T, spec, layers, B, 1)
        return want + head_of(eng.params, B)

    def segments(n_tokens):
        """Decode steps of Engine.generate for ``n_tokens``: whole segments
        of 32 after the prefill's token."""
        return -(-(n_tokens - 1) // 32) * 32

    @contextlib.contextmanager
    def scripted_input(lines):
        """``input()`` answers ``lines``, then raises EOFError."""
        import builtins

        answers, saved = iter(lines), builtins.input

        def answer(prompt=""):
            print(prompt, end="")
            try:
                return next(answers)
            except StopIteration:
                raise EOFError from None

        builtins.input = answer
        try:
            yield
        finally:
            builtins.input = saved

    def quiet(fn, argv, lines=None):
        """An app's ``main(argv)`` with its printed output kept (and
        ``input()`` answering ``lines``): its result, its seconds (the
        load included) and its stdout and stderr lines."""
        out, err = io.StringIO(), io.StringIO()
        with contextlib.ExitStack() as stack:
            stack.enter_context(contextlib.redirect_stdout(out))
            stack.enter_context(contextlib.redirect_stderr(err))
            if lines is not None:
                stack.enter_context(scripted_input(lines))
            t0 = time.perf_counter()
            res = fn(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        return res, secs, out.getvalue().split("\n"), err.getvalue().split("\n")

    @contextlib.contextmanager
    def numpy_only():
        """The load path as on a machine without g++: numpy dequantizes."""
        from web_rwkv_gguf_tpu_torch import native

        saved = native._lib, native._tried
        native._lib, native._tried = None, True
        try:
            yield
        finally:
            native._lib, native._tried = saved

    def greedy_loop(eng, tok, prompt, n_tokens, stopped):
        """gen's per-token loop on ``eng`` (Engine.infer, the greedy host
        sampler): the tokens after ``prompt`` until ``stopped(text)``."""
        from web_rwkv_gguf_tpu_torch.utils.sampling import GreedySampler

        eng.reset_state()
        inp = runtime.RnnInput([runtime.RnnInputBatch(list(prompt), runtime.RnnOption.LAST)],
                               eng.token_chunk_size)
        while inp.num_token:
            out = eng.infer(inp)
            if len(out[0]):
                logits = out[0][-1]
        toks, text = [], ""
        for _ in range(n_tokens):
            toks.append(GreedySampler().sample(runtime.softmax(logits[None, :])[0]))
            text += tok.decode([toks[-1]]).decode("utf-8", "replace")
            if stopped(text):
                break
            inp.batches[0].push(toks[-1])
            logits = eng.infer(inp)[0][-1]
        return toks

    def apps_phase(tag, spec, info, params, raw, converted):
        """The apps (``spec["apps"]``, see APP_PROMPT) through their main()
        on the model's file: each counted where its route is fixed, its
        tokens against the same Engine's library path, a line each."""
        from web_rwkv_gguf_tpu_torch import native
        from web_rwkv_gguf_tpu_torch.apps import (batch, chat, gen, inspect, othello, ppl,
                                                  puzzle15, serde)
        from web_rwkv_gguf_tpu_torch.utils import trace
        from web_rwkv_gguf_tpu_torch.utils.tokenizer import Tokenizer

        parts, L = spec["apps"], info.num_layer
        t_phase = time.perf_counter()
        tmp = tempfile.mkdtemp()
        try:
            model, vocab = f"{tmp}/{tag}.gguf", f"{tmp}/vocab.json"
            with open(model, "wb") as f:
                f.write(raw)
            with open(vocab, "w") as f:
                json.dump(byte_vocab(info.num_vocab), f)
            tok = Tokenizer.from_file(vocab)
            base = ["--model", model, "--vocab", vocab, "--device", "cuda"]
            greedy = ["--sampler", "greedy", "--prompt", APP_PROMPT]
            prompt = tok.encode(APP_PROMPT)
            eng = runtime.Engine(info, params, 1, device="cuda")
            pre, step = engine_prefill(spec, eng, [len(prompt)]), engine_step(spec, eng)
            fused_want = pre + times(step, segments(APP_TOKENS))

            def stopped(text):  # gen's default stop
                return "\n\n" in text

            def gen_infers(toks):  # gen's infer calls after the prompt
                text = ""
                for i, t in enumerate(toks):
                    text += tok.decode([t]).decode("utf-8", "replace")
                    if stopped(text):
                        return i
                return len(toks)

            if "gen" in parts:
                toks, secs, _, err = counted(
                    f"{tag} apps gen (per token)",
                    lambda r: pre + times(step, gen_infers(r[0])),
                    lambda: quiet(gen.main, base + greedy + ["--max-tokens", str(APP_TOKENS)]))
                same = toks == greedy_loop(eng, tok, prompt, APP_TOKENS, stopped)
                log(f"{tag} apps gen (per token): {len(toks)} greedy tokens after a "
                    f"{len(prompt)}-token prompt, each step {dict(step)}; {secs:.2f} s with the "
                    f"load; tokens {'equal' if same else 'DIFFER from'} the Engine.infer loop's; "
                    f"the app's line {err[-2]!r}, on {smi}")
                if not same:
                    raise AssertionError(f"{tag}: gen's tokens are not the Engine's")
            if "gen" in parts or "serde" in parts:
                fused, secs, _, err = counted(
                    f"{tag} apps gen --fused", fused_want,
                    lambda: quiet(gen.main, base + greedy + ["--fused", "--max-tokens",
                                                             str(APP_TOKENS)]))
                eng.reset_state()
                same = fused == eng.generate([prompt], APP_TOKENS)[0]
                log(f"{tag} apps gen --fused: {len(fused)} tokens, {segments(APP_TOKENS)} "
                    f"decode steps; {secs:.2f} s with the load; tokens "
                    f"{'equal' if same else 'DIFFER from'} Engine.generate's; the app's line "
                    f"{err[-2]!r}, on {smi}")
                if not same:
                    raise AssertionError(f"{tag}: gen --fused's tokens are not the Engine's")
            if "gen_nf4" in parts:
                toks, secs, out, _ = counted(
                    f"{tag} apps gen --quant nf4 --fused", fused_want,
                    lambda: quiet(gen.main, base + ["--quant", "nf4"] + greedy
                                  + ["--fused", "--max-tokens", str(APP_TOKENS)]))
                eng.reset_state()
                same = toks == eng.generate([prompt], APP_TOKENS)[0]
                log(f"{tag} apps gen --quant nf4 --fused: {len(toks)} tokens, each step "
                    f"{dict(step)}; {secs:.2f} s with the load ({out[0]!r}); tokens "
                    f"{'equal' if same else 'DIFFER from'} Engine.generate's on the same load")
                if not same:
                    raise AssertionError(f"{tag}: gen --quant nf4's tokens are not the Engine's")
            if "batch" in parts:
                prompts = [tok.encode(p) for p in batch.DEFAULT_PROMPTS]
                eng4 = runtime.Engine(info, params, len(prompts), device="cuda")
                want = (engine_prefill(spec, eng4, [len(p) for p in prompts])
                        + times(engine_step(spec, eng4), segments(APP_TOKENS)))
                outs, secs, out, _ = counted(
                    f"{tag} apps batch --fused", want,
                    lambda: quiet(batch.main, base + ["--sampler", "greedy", "--fused",
                                                      "--max-tokens", str(APP_TOKENS)]))
                same = outs == eng4.generate(prompts, APP_TOKENS)
                log(f"{tag} apps batch --fused: {len(prompts)} lanes of "
                    f"{[len(p) for p in prompts]} prompt tokens, {APP_TOKENS} tokens each; "
                    f"{secs:.2f} s with the load; tokens {'equal' if same else 'DIFFER from'} "
                    f"Engine.generate's; the app's line {out[-2]!r}")
                del eng4
                if not same:
                    raise AssertionError(f"{tag}: batch --fused's tokens are not the Engine's")
            if "chat" in parts:
                loads, real = [], runtime.Engine.load_state

                def load_state(self, lane, snapshot):
                    real(self, lane, snapshot)
                    loads.append(all(np.array_equal(self.back_state(lane)[k], snapshot[k])
                                     for k in snapshot))

                runtime.Engine.load_state = load_state
                try:
                    _, secs, out, _ = quiet(chat.main, base + ["--sampler", "greedy",
                                                               "--max-tokens", str(CHAT_TOKENS)],
                                            CHAT_LINES)
                finally:
                    runtime.Engine.load_state = real
                replies = [line for line in out if line.startswith("Bob: Alice:")]
                retried = len(replies) == 3 and replies[0] == replies[1]
                ok = loads == [True, True] and retried and "Bob: [conversation reset]" in out
                log(f"{tag} apps chat (fused segments of 8, greedy): lines {list(CHAT_LINES)}; "
                    f"the '+' and '-' loads give back_state's state bit for bit: {loads}; the "
                    f"retried reply equals the first: {retried}; {secs:.2f} s with the load")
                if not ok:
                    raise AssertionError(f"{tag}: chat's retry or reset did not restore the state")
            if "ppl" in parts:
                text = f"{tmp}/text.txt"
                with open(text, "w") as f:
                    f.write(ppl_text())
                layers, n = layer_params(params, L), PPL_TOKENS + 1
                want = collections.Counter()
                for pos in range(0, n, PPL_CHUNK):
                    T = min(PPL_CHUNK, n - pos)
                    want += expected_chunk(WKV7_CHUNKED_MIN_T, spec, layers, 1, T)
                    if n - pos - 1 > 0:
                        want += head_of(params, min(T, n - pos - 1))
                (pp, nll, scored), secs, out, _ = counted(
                    f"{tag} apps ppl", want,
                    lambda: quiet(ppl.main, base + ["--text", text, "--max-tokens",
                                                    str(PPL_TOKENS), "--chunk", str(PPL_CHUNK)]))
                log(f"{tag} apps ppl: {scored} tokens in chunks of {PPL_CHUNK}: nll {nll:.6f}, "
                    f"ppl {pp:.3f}; {secs:.2f} s with the load; the app's line {out[-2]!r}")
                if not (scored == PPL_TOKENS and math.isfinite(nll)):
                    raise AssertionError(f"{tag}: ppl scored {scored} tokens, nll {nll}")
                res, secs, out, _ = quiet(ppl.main, base + [
                    "--text", text, "--max-tokens", str(PPL_CHUNK), "--chunk", str(PPL_CHUNK),
                    "--compare-f16"])
                log(f"{tag} apps ppl --compare-f16 ({PPL_CHUNK} tokens): "
                    + "; ".join(f"{mode} nll {r[1]:.6f}, load {r[3]:.2f} s"
                                for mode, r in res.items())
                    + f"; {out[2]!r}; {out[3]!r} (random weights: the bar is for a trained "
                    f"model); {secs:.2f} s")
            if "serde" in parts:
                snap = f"{tmp}/model.rwkvz"
                _, secs, out, _ = quiet(serde.main, base + ["--output", snap])
                toks, secs2, _, _ = counted(
                    f"{tag} apps gen --fused from the serde snapshot", fused_want,
                    lambda: quiet(gen.main, ["--model", snap] + base[2:] + greedy
                                  + ["--fused", "--max-tokens", "8"]))
                log(f"{tag} apps serde: {out[-2]!r}; gen --fused from it: {secs2:.2f} s with "
                    f"the load; its 8 tokens {'equal' if toks == fused[:8] else 'DIFFER from'} "
                    f"gen --fused's from the GGUF file")
                if toks != fused[:8]:
                    raise AssertionError(f"{tag}: gen from the snapshot gave other tokens")
            if "inspect" in parts:
                _, secs, out, _ = quiet(inspect.main, [model, "--tensors", "--detect"])
                log(f"{tag} apps inspect --tensors --detect: {len(out) - 1} lines, "
                    f"{out[1]!r}, {out[-2][:100]!r}; {secs:.2f} s")
                if not out[-2].startswith("detected: ModelInfo(version=<ModelVersion.V7"):
                    raise AssertionError(f"{tag}: inspect did not detect the model")
            for app_name in ("othello", "puzzle15"):
                if app_name not in parts:
                    continue
                app = othello if app_name == "othello" else puzzle15
                h_eng = runtime.Engine(info, params, 1, hooks=HOOK_EXAMPLES[app_name](L),
                                       device="cuda")
                h_pre = engine_prefill(spec, h_eng, [len(tok.encode(app.DEFAULT_PROMPT))])
                h_step = engine_step(spec, h_eng)
                toks, secs, _, _ = counted(
                    f"{tag} apps {app_name}",
                    lambda r: h_pre + times(h_step, len(r[0]) - (r[0][-1] in app.STOP_TOKENS)),
                    lambda: quiet(app.main, base + ["--max-tokens", str(GAME_TOKENS)]))
                log(f"{tag} apps {app_name}: {len(tok.encode(app.DEFAULT_PROMPT))}-token "
                    f"prompt, {len(toks)} greedy tokens {toks}, each step {dict(h_step)}; "
                    f"{secs:.2f} s with the load")
                del h_eng
            if "trace" in parts:
                tdir = f"{tmp}/trace"
                with trace.trace_to(tdir) as prof:
                    with trace.span("apps gen --fused"):
                        quiet(gen.main, base + greedy + ["--fused", "--max-tokens", "8"])
                names = []
                for path in os.listdir(tdir):
                    with open(f"{tdir}/{path}") as f:
                        names += [e.get("name", "") for e in json.load(f)["traceEvents"]]
                n7 = sum("layer7_kernel" in name for name in names)
                log(f"{tag} apps trace (utils.trace.trace_to around gen --fused, 8 tokens): "
                    f"{len(names)} events in {os.listdir(tdir)}; {n7} name layer7_kernel; the "
                    f"span named: {'apps gen --fused' in names}; "
                    f"{len(prof.key_averages())} keys")
                if n7 < segments(8) or "apps gen --fused" not in names:
                    raise AssertionError(f"{tag}: the trace does not name layer7's kernel")
            if "native" in parts:
                loaded = native.get_lib() is not None
                direct = {}
                for label in ("native", "numpy"):
                    with numpy_only() if label == "numpy" else contextlib.nullcontext():
                        t0 = time.perf_counter()
                        direct[label] = models.load_model(
                            GgufFile(raw, allow_quantized_direct=False), device="cuda")[1]
                        torch.cuda.synchronize()
                        direct[label + " s"] = time.perf_counter() - t0
                diff = same_params(direct["native"], direct["numpy"])
                log(f"{tag} apps native: get_lib() loaded {loaded}; load_model(GgufFile("
                    f"allow_quantized_direct=False)) on cuda {direct['native s']:.2f} s with the "
                    f"C++ dequant against {direct['numpy s']:.2f} s with numpy's (warm file "
                    f"cache); params differing: {diff or 'none'}")
                del direct
                if not loaded or diff:
                    raise AssertionError(f"{tag}: the native library is not what loads the model")
            if converted is not None:
                data, secs, out = converted.get()
                info_c, p_c = models.load_model(GgufFile(data), device="cuda")
                eng_c = runtime.Engine(info_c, p_c, 1, device="cuda")
                want = engine_prefill(spec, eng_c, [len(prompt)]) + engine_step(spec, eng_c)
                toks = counted(f"{tag} apps convert q8_0, one Engine step", want,
                               lambda: eng_c.generate([prompt], 2, segment=1))
                kinds = (p_c["blocks"]["att"]["Wk"].kind, p_c["head"].kind)
                log(f"{tag} apps convert: {out} in {secs:.2f} s in a worker process "
                    f"({CONVERT_LAYERS} layers at the 0.1B widths, seed {CONVERT_SEED}); loaded "
                    f"as {kinds}, {info_c}; prefill and one step {dict(want)}; tokens {toks}")
                if info_c.num_layer != CONVERT_LAYERS or not all(0 <= t < VOCAB for t in toks[0]):
                    raise AssertionError(f"{tag}: the converted model did not run")
                del eng_c, p_c
            del eng
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
        log(f"{tag} apps phase: {time.perf_counter() - t_phase:.1f} s")

    def ppl_vs_cpu(tag, info2, p_gpu, p_cpu):
        """apps.ppl.evaluate_ppl of the PPL_TOKENS-token text on the two-layer
        model, the card against the CPU, within PPL_TOL relative."""
        from web_rwkv_gguf_tpu_torch.apps.ppl import evaluate_ppl
        from web_rwkv_gguf_tpu_torch.utils.tokenizer import Tokenizer

        tok = Tokenizer(byte_vocab(info2.num_vocab))
        t0 = time.perf_counter()
        card, cpu = (evaluate_ppl(info2, p, tok, ppl_text(), chunk=PPL_CHUNK,
                                  max_tokens=PPL_TOKENS) for p in (p_gpu, p_cpu))
        rel = abs(card[1] - cpu[1]) / abs(cpu[1])
        log(f"{tag} apps ppl, card vs CPU, L={COMPARE_LAYERS}: nll {card[1]:.6f} against "
            f"{cpu[1]:.6f} ({card[2]} tokens), relative {rel:.3e} (limit {PPL_TOL}); "
            f"{time.perf_counter() - t0:.1f} s")
        if not rel <= PPL_TOL:
            raise AssertionError(f"{tag}: ppl's nll on the card disagrees with the CPU")

    for tag in files:
        spec = MODELS[tag]
        log(f"{tag}: {time.perf_counter() - t_start:.1f} s into the run")
        raw, t_file = files[tag]["full"].get()
        log(f"{tag} model file: {len(raw) / 1e6:.1f} MB built in {t_file:.1f} s in a worker "
            f"process ({spec['widths']}, seed {spec['seed']})")
        t0 = time.perf_counter()
        info, params = load(models, raw, spec, "cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        log(f"{tag} load_model on cuda: {t_load:.1f} s; "
            f"{torch.cuda.memory_allocated() / 1e6:.1f} MB on the card; {info}")
        blocks = params["blocks"]
        layer_kind, head_kind = spec["kinds"]
        if (info.version.value != tag[:2] or params["head"].kind != head_kind
                or any(blocks[p][n].kind != layer_kind for p, n in spec["matrices"])):
            raise AssertionError(f"{tag}: the model did not load as {spec['kinds']}")
        drive(tag, spec, info, params)
        if spec.get("hooks"):
            hooks_phase(tag, spec, info, params)
        if spec.get("embeds"):
            embeds_phase(tag, info, params)
        if spec.get("vision"):
            vision_phase(tag, info, params)
        if spec.get("lora"):
            lora_phase(tag, spec, info, raw)
        if spec.get("lora_layer0"):
            lora_layer0_phase(tag, spec, info, raw)
        if spec.get("apps"):
            apps_phase(tag, spec, info, params, raw, files[tag].get("convert"))
        t0 = time.perf_counter()
        if spec.get("snapshot"):
            snapshot_phase(tag, info, params, t_load)
        if spec.get("safetensors"):
            safetensors_phase(tag, info, params, raw)
        if spec.get("snapshot") or spec.get("safetensors"):
            log(f"{tag} file phases: {time.perf_counter() - t0:.1f} s")
        del raw, info, params, blocks
        t0 = time.perf_counter()
        raw2, t_file = files[tag]["compare"].get()
        info2, p_gpu = load(models, raw2, spec, "cuda")
        p_cpu = load(models, raw2, spec, "cpu")[1]
        card_vs_cpu(tag, spec, info2, p_gpu, p_cpu)
        if "ppl" in spec.get("apps", ()):
            ppl_vs_cpu(tag, info2, p_gpu, p_cpu)
        if any(spec.get(k) for k in ("hooks", "vision", "direct", "lora")):
            surface_vs_cpu(tag, spec, raw2, info2, p_gpu, p_cpu)
        if spec.get("dense_compare"):
            t1 = time.perf_counter()
            dense_logits(tag, spec, info2, p_gpu)
            log(f"{tag} dense against quantized on L={COMPARE_LAYERS}: "
                f"{time.perf_counter() - t1:.1f} s")
        log(f"{tag} card vs CPU: {time.perf_counter() - t0:.1f} s (its file built in "
            f"{t_file:.1f} s in a worker process, seed {compare_seed(spec)})")
        del raw2, info2, p_gpu, p_cpu
        torch.cuda.empty_cache()
        for j, (version, slot_kind) in enumerate(SLOT_STACKS.get(tag, ())):
            label = f"slot {version} {slot_kind or 'bf16'}"
            t0 = time.perf_counter()
            raw3, t_file = files[tag][label].get()
            slot_stack(label, version, slot_kind, raw3)
            log(f"{label}: {time.perf_counter() - t0:.1f} s ({len(raw3) / 1e6:.1f} MB file "
                f"built in {t_file:.1f} s in a worker process, {SLOT_WIDTHS[version]}, seed "
                f"{SLOT_SEED + j})")
            del raw3
            torch.cuda.empty_cache()

    # "launches": the kernel's count over the main paths' runs; by path and
    # at this entry's shape ("launches_at_shape", 0 for a shape off the paths)
    for entry, case in zip(entries, cases):
        kname = case["kernel"].__name__
        entry["launches"] = sum(p[kname] for p in path_launches.values())
        entry["launches_by_path"] = {path: p[kname] for path, p in path_launches.items()}
        entry["launches_at_shape"] = sum(s[kname][case["shape"]]
                                         for s in path_shapes.values())

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
