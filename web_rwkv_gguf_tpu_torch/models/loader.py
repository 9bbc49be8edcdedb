"""Build the RWKV-7, -6, -5 or -4 parameter tree from a GGUF reader.

The tree holds the same logical arrays as the JAX package's loader, as
torch tensors on one device:

- layer params are stacked with a leading ``[L, ...]`` axis (per-layer
  lists instead when the layers' matrices differ in kind or shape, as in
  a llama.cpp Q4_K_M file that keeps some matrices in Q6_K);
- big matrices are :class:`Matrix` (direct-quantized from any block
  type ``GgufFile.quantized_tensor`` returns — Q8_0, Q4_0, Q4_1, Q5_0,
  Q5_1, Q2_K to Q6_K — or, after an f16 round trip, requantized by the
  layer's scheme (``load_model(quant=)``: Int8, NF4, SF4) or dense in the
  model dtype; the head is never requantized);
- the adapters (V7's inner LoRAs, V6's ``tm_w1`` / ``tm_w2`` /
  ``td_w1`` / ``td_w2``) are dense in the model dtype; vectors are f32
  (V5's decay activated at load as exp(-exp(raw)) per head, V4's as
  -exp(raw) per channel);
- the embedding table stays f16.

``load_model(lora=)`` merges LoRA patches at load (:class:`LoraPatch`),
as the JAX package's ``_Loader`` does: a vector becomes α·lora + (1−α)·x
before any activation at load, and a matrix gains α/rank·B@A on its f32
weight before the f16 round trip and its layer's scheme (a LoRA'd matrix
never loads direct-quantized).

The load computes in numpy and moves each finished array to ``device``
once.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch

from ..errors import TensorNotFound
from ..ops.cuda.layer7 import MAX_SCAN_BATCH, prep_decode7
from ..ops.cuda.layer56 import prep_decode56
from ..quant.formats import QuantScheme
from .info import ModelVersion, detect_info
from .matrix import Matrix, gemv_block_m, gemv_scales

# the kinds the grouped r/k/v gemv takes (ops/cuda/matmul.py::quant_gemv_grouped)
GROUP_KINDS = ("qk", "qk_b", "qk_nomin", "int8")


def _np(reader, name, dtype=np.float32) -> np.ndarray:
    return np.asarray(reader.tensor(name, dtype))


@dataclass
class LoraPatch:
    """A LoRA to merge at load (the JAX package's ``LoraPatch``; ref:
    loader.rs Lora / LoraBlend).

    ``reader``: any reader with ``contains`` and ``tensor`` (``GgufFile``,
    ``io.SafetensorsFile``) holding vectors under the model's names and
    matrices as ``{name}.lora.0`` (A, [rank, K]) and ``{name}.lora.1`` (B,
    [M, rank]). ``blend`` maps regex patterns to α; the last pattern that
    matches a name wins (ref: loader.rs:373-441)."""

    reader: object
    blend: list[tuple[str, float]] = field(default_factory=list)

    # the reference's big-matrix pattern (loader.rs:166-174)
    MATRIX_PATTERN = (r"blocks\.([0-9]+)\.(att|ffn)\."
                      r"(key|value|receptance|gate|output)\.weight")

    @classmethod
    def full(cls, reader, alpha: float) -> "LoraPatch":
        """Replace every vector, add to every matrix with ``alpha`` (ref:
        loader.rs:150-155 ``LoraBlend::full``)."""
        return cls(reader, cls.blend_full(alpha))

    @staticmethod
    def blend_full(alpha: float) -> list[tuple[str, float]]:
        return LoraPatch.blend_nominal(1.0) + LoraPatch.blend_matrices(alpha)

    @staticmethod
    def blend_nominal(alpha: float) -> list[tuple[str, float]]:
        """Every tensor with factor ``alpha`` (ref: loader.rs:158-163)."""
        return [(r".+", alpha)]

    @staticmethod
    def blend_matrices(alpha: float) -> list[tuple[str, float]]:
        """Every big matrix with ``alpha`` (ref: loader.rs:166-174)."""
        return [(LoraPatch.MATRIX_PATTERN, alpha)]

    @staticmethod
    def blend_layer_nominal(layer: int, alpha: float) -> list[tuple[str, float]]:
        """Every tensor of one layer (ref: loader.rs:177-182)."""
        return [(rf"blocks\.{layer}", alpha)]

    @staticmethod
    def blend_layer_matrices(layer: int, alpha: float) -> list[tuple[str, float]]:
        """The big matrices of one layer (ref: loader.rs:185-191)."""
        return [(rf"blocks\.{layer}\.(att|ffn)\.(key|value|receptance|gate|output)\.weight",
                 alpha)]

    def alpha(self, name: str) -> float | None:
        """α of the last pattern that matches ``name``; None if none does."""
        out = None
        for pattern, a in self.blend:
            if re.search(pattern, name):
                out = a
        return out


def _lora_vector(patches, name, v: np.ndarray) -> np.ndarray:
    """``v`` blended with every patch that holds ``name``: α·lora + (1−α)·v
    (ref: loader.rs:459-476)."""
    for patch in patches:
        alpha = patch.alpha(name) if patch.reader.contains(name) else None
        if alpha is not None:
            v = alpha * _np(patch.reader, name).reshape(-1) + (1.0 - alpha) * v
    return v


def _lora_pairs(patches, name) -> list:
    """``(α, A, B)`` of every patch that holds a pair for matrix ``name``."""
    out = []
    for patch in patches:
        a_name, b_name = f"{name}.lora.0", f"{name}.lora.1"
        if patch.reader.contains(a_name) and patch.reader.contains(b_name):
            alpha = patch.alpha(name)
            if alpha is not None:
                out.append((alpha, _np(patch.reader, a_name), _np(patch.reader, b_name)))
    return out


def _lora_matrix(pairs, w: np.ndarray) -> np.ndarray:
    """``w`` plus α/rank·B@A of every pair (ref: loader.rs blend_lora)."""
    for alpha, a, b in pairs:
        rank = a.shape[0] if a.ndim == 2 else 1
        w = w + (alpha / rank) * (b @ a)
    return w


def _stack_matrices(mats: list[Matrix]):
    """Stack per-layer matrices into one Matrix with a leading L axis, or
    return the list when their kinds or shapes differ."""
    kind, shape = mats[0].kind, mats[0].shape
    if any(m.kind != kind or m.shape != shape or set(m.arrays) != set(mats[0].arrays)
           for m in mats):
        return mats
    return Matrix(kind, shape, {k: torch.stack([m.arrays[k] for m in mats])
                                for k in mats[0].arrays})


def _layer_slice(tree, i):
    if isinstance(tree, list):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, Matrix):
        return tree.layer(i)
    return tree[i]


def _has_list(tree) -> bool:
    if isinstance(tree, list):
        return True
    if isinstance(tree, dict):
        return any(_has_list(v) for v in tree.values())
    return False


def layer_params(params: dict, num_layer: int) -> list[dict]:
    """Per-layer views of ``params["blocks"]`` (no copies)."""
    blocks = params["blocks"]
    if isinstance(blocks, list):
        return blocks
    return [_layer_slice(blocks, i) for i in range(num_layer)]


def group_gemv_matrices(mats: list) -> dict | None:
    """The operands of the grouped decode gemv (``ops/cuda/matmul.py::
    quant_gemv_grouped``) for same-shape single-layer matrices: ``codes``,
    the matrices' own code tensors (not copied), and their f32 group scale
    products ``scales`` and signed offsets ``offsets`` (None where the
    kind has none) stacked ``[len(mats), M, G]`` (``matrix.gemv_scales``).
    None where the JAX package's ``group_gemv_matrices`` declines: a
    matrix that is not quantized in one of :data:`GROUP_KINDS`, kinds or
    dims that differ, or codes whose gemv tiles M (``_gemv_block_m(m,
    kdim) != m``: at C = 2048, Q4_K groups but Q5_K, Q8_0 and Int8 do not)."""
    if not all(isinstance(mt, Matrix) for mt in mats):
        return None
    kind = mats[0].kind
    if kind not in GROUP_KINDS:
        return None
    m, k = mats[0].dims()
    if any(mt.kind != kind or mt.dims() != (m, k) for mt in mats):
        return None
    if gemv_block_m(m, mats[0].arrays["codes"].shape[-1]) != m:
        return None
    scales, offsets = zip(*(gemv_scales(mt) for mt in mats))
    return {"codes": [mt.arrays["codes"] for mt in mats],
            "scales": torch.stack(scales).contiguous(),
            "offsets": None if offsets[0] is None else torch.stack(offsets).contiguous()}


def unroll_params(params: dict) -> dict:
    """Params with the stacked ``[L, ...]`` blocks as a list of per-layer
    blocks (views, no copies), as the JAX package's ``unroll_params``
    arranges its unrolled decode: each RWKV-7 layer whose r, k and v
    matrices group (:func:`group_gemv_matrices`) gets them as
    ``att["Wrkv_g"]``, which ``forward_chunk`` at T = 1 and one lane
    multiplies in one ``quant_gemv_grouped`` launch. The JAX package also
    attaches them to RWKV-6, -5 and -4 layers, where nothing reads them;
    the port attaches them only where its forward reads them. List-form
    blocks come back unchanged."""
    blocks = params["blocks"]
    if isinstance(blocks, list):
        return params
    layers = [_layer_slice(blocks, i) for i in range(blocks["ln1"]["w"].shape[0])]
    for blk in layers:
        att = blk["att"]
        if "w0" in att:  # an RWKV-7 layer
            grouped = group_gemv_matrices([att["Wr"], att["Wk"], att["Wv"]])
            if grouped is not None:
                att["Wrkv_g"] = grouped
    return {**params, "blocks": layers}


def _walk_matrices(tree):
    """Every :class:`Matrix` of a parameter tree (dicts and lists)."""
    if isinstance(tree, Matrix):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _walk_matrices(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _walk_matrices(v)


def dense_cache_bytes(params: dict, itemsize: int = 2) -> int:
    """Device bytes that :func:`densify_matrices` would add: a dense copy
    of every quantized matrix of the head and the blocks at ``itemsize``
    bytes an element (the JAX package's ``dense_cache_bytes``, which the
    Engine's dense policies read)."""
    total = 0
    for mat in _walk_matrices([params.get("head"), params.get("blocks")]):
        if mat.kind != "dense":
            m, k = mat.dims()
            codes = mat.arrays["codes"]
            total += (codes.shape[0] if codes.dim() == 3 else 1) * m * k * itemsize
    return total


# elements of f32 weight a densify step holds at once (16 MB)
_DENSIFY_ELEMENTS = 1 << 22


def _densify(mat: Matrix, dtype) -> Matrix:
    """A dense copy of ``mat`` in ``dtype``, dequantized a layer and a block
    of rows at a time into the preallocated result, so that no f32 weight
    larger than :data:`_DENSIFY_ELEMENTS` is held beside it."""
    m, k = mat.dims()
    codes = mat.arrays["codes"]
    stacked = codes.dim() == 3
    layers = codes.shape[0] if stacked else 1
    out = torch.empty((layers, m, k), dtype=dtype, device=codes.device)
    rows = max(1, _DENSIFY_ELEMENTS // k)
    for i in range(layers):
        layer = mat.layer(i) if stacked else mat
        for r0 in range(0, m, rows):
            part = Matrix(mat.kind, mat.shape, {
                key: a if key == "lut" else a[r0:r0 + rows] for key, a in layer.arrays.items()})
            out[i, r0:r0 + rows] = part.dequantize()
    return Matrix.dense(out if stacked else out[0])


def densify_matrices(params: dict, dtype=torch.bfloat16) -> dict:
    """Params with a dense ``dtype`` copy of every quantized matrix, the
    head included, for stacked and per-layer (list) blocks alike (the JAX
    package's ``densify_matrices``): the Engine's dense prefill cache and
    its dense decode weights. Each copy is made a layer and a block of
    rows at a time (:func:`_densify`). The whole-stack decode blocks
    (``mega7``, ``mega56``) and the grouped gemv operands (``Wrkv_g``)
    multiply the quantized arrays and are left out; ``prepare_decode``
    rebuilds them from the dense copy."""

    def walk(tree):
        if isinstance(tree, Matrix):
            return tree if tree.kind == "dense" else _densify(tree, dtype)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items() if k != "Wrkv_g"}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    out = {k: v for k, v in params.items() if k not in ("mega7", "mega56")}
    out["head"] = walk(params["head"])
    out["blocks"] = walk(params["blocks"])
    return out


def load_initial_state(reader, info) -> np.ndarray:
    """A pretrained ``time_state`` (each layer's initial WKV state) from a
    file, as the ``[L, H, K, V]`` f32 array ``Engine(initial_wkv=)`` takes
    (the JAX package's ``load_initial_state``; ref: v7.rs:1229-1262). Each
    layer's ``blocks.{i}.att.time_state`` is stored ``[H·V, K]``."""
    L, H, hs = info.num_layer, info.num_head, info.head_size
    out = np.zeros((L, H, hs, hs), np.float32)
    for layer in range(L):
        st = _np(reader, f"blocks.{layer}.att.time_state")
        out[layer] = st.reshape(H, hs, hs).transpose(0, 2, 1)
    return out


def prepare_decode(params: dict, info, batch_hint: int = 1) -> dict:
    """Params arranged for decode, as the JAX package's ``prepare_decode``
    arranges them for its Engine: the whole-stack decode blocks attached,
    so that a T=1 forward of up to ``MAX_SCAN_BATCH`` lanes runs as one
    kernel launch (``params["mega7"]`` for RWKV-7, from
    ``ops/cuda/layer7.prep_decode7``; ``params["mega56"]`` for RWKV-6, -5
    and -4, from ``ops/cuda/layer56.prep_decode56``). Where they cannot be
    attached (a batch above the limit, per-layer blocks, a model the
    whole-stack kernels do not take: a layer matrix in NF4 / SF4 or dense
    f32, as ``layer7.stack_matrix`` says, or widths ``prep_decode7`` /
    ``prep_decode56`` refuse) it returns :func:`unroll_params`.
    Idempotent."""
    if "mega7" in params or "mega56" in params:
        return params
    if batch_hint <= MAX_SCAN_BATCH:
        if info.version == ModelVersion.V7:
            key, mega = "mega7", prep_decode7(params, info)
        else:
            key, mega = "mega56", prep_decode56(params, info)
        if mega is not None:
            return {**params, key: mega}
    return unroll_params(params)


def load_model(reader, *, quant=None, lora: list[LoraPatch] | None = None,
               dtype=torch.bfloat16, rescale: int | None = None, device="cuda"):
    """Load an RWKV-7, -6, -5 or -4 model into ``(info, params)`` on ``device``.

    ``quant``: the engine's requantization, one ``QuantScheme`` for every
    layer or ``{layer: scheme}`` (layers not named stay NONE), as the JAX
    package's ``load_model(quant=)`` takes it. It applies to each layer
    matrix that does not load direct-quantized: every matrix of an f16 /
    f32 file, and the rescale-discounted ones of any file (the JAX
    package's ``_Loader.matrix``). Layers of mixed kinds load as
    per-layer (list) blocks. ``dtype`` is the storage type of dense
    matrices and adapters (bf16 or f32). ``rescale``: the weights of
    ``att.output`` / ``ffn.value`` at layer i are pre-multiplied by
    ``2^-(i // rescale)`` (those matrices then load dense or by the
    layer's scheme) and the forward halves the residual every
    ``rescale`` layers. ``lora``: patches merged at load
    (:class:`LoraPatch`); a merged matrix loads through the f16 round trip
    and its layer's scheme, never direct-quantized, so a file whose
    layers differ in that way loads as per-layer blocks.
    """
    info = detect_info(reader)
    lora = lora or []
    if isinstance(quant, QuantScheme):
        quant = {i: quant for i in range(info.num_layer)}
    quant = quant or {}
    rescale = rescale or 10**9
    C, L, H, hs = info.num_emb, info.num_layer, info.num_head, info.head_size

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(a, requirements="CW")).to(device)

    def vector(name):
        return _lora_vector(lora, name, _np(reader, name).reshape(-1))

    def matrix_f32(name, pairs=None):
        return _lora_matrix(_lora_pairs(lora, name) if pairs is None else pairs,
                            _np(reader, name))

    def to_dtype(a: np.ndarray) -> torch.Tensor:
        return dev(a.astype(np.float32)).to(dtype)

    def matrix(name, discount=1.0, layer=None) -> Matrix:
        pairs = _lora_pairs(lora, name)
        if discount == 1.0 and not pairs:
            qt = reader.quantized_tensor(name)
            if qt is not None:
                return Matrix.from_gguf_blocks(qt[0], qt[1], reader.shape(name),
                                               device=device)
        w = matrix_f32(name, pairs) * discount
        # the f16 round trip the reference loader applies before its scheme
        return Matrix.from_f16(w.astype(np.float16), quant.get(layer, QuantScheme.NONE),
                               dtype, device)

    def vecs(fmt):
        return dev(np.stack([vector(fmt.format(i=i)) for i in range(L)]))

    def mats(fmt, discounted=False):
        return _stack_matrices([
            matrix(fmt.format(i=i), 2.0 ** -(i // rescale) if discounted else 1.0, i)
            for i in range(L)
        ])

    def adapters(fmt):
        return to_dtype(np.stack([matrix_f32(fmt.format(i=i)) for i in range(L)]))

    def ln(prefix):
        return {"w": vecs(prefix + ".weight"), "b": vecs(prefix + ".bias")}

    if info.version == ModelVersion.V6:
        # the five static mixes stacked in (w, k, v, r, g) order: [L, 5, C]
        time_mix = np.stack([np.stack([vector(f"blocks.{i}.att.time_mix_{s}")
                                       for s in "wkvrg"]) for i in range(L)])
        att = {
            "time_decay": vecs("blocks.{i}.att.time_decay"),  # raw: the forward activates it
            "time_first": vecs("blocks.{i}.att.time_first").reshape(L, H, hs),
            "mix_x": vecs("blocks.{i}.att.time_mix_x"),
            "time_mix": dev(time_mix),
            "tm_w1": adapters("blocks.{i}.att.time_mix_w1"),  # [L, 5R, C]
            "tm_w2": adapters("blocks.{i}.att.time_mix_w2"),  # [L, 5, C, R]
            "td_w1": adapters("blocks.{i}.att.time_decay_w1"),  # [L, D, C]
            "td_w2": adapters("blocks.{i}.att.time_decay_w2"),  # [L, C, D]
            "gn": ln("blocks.{i}.att.ln_x"),
            **_att_matrices(mats, gate=True),
        }
    elif info.version == ModelVersion.V7:
        att, ffn = _v7_blocks(reader, info, vector, matrix_f32, to_dtype, dev, vecs, mats,
                              adapters, ln)
    else:
        raw_decay = np.stack([vector(f"blocks.{i}.att.time_decay") for i in range(L)])
        v5 = info.version == ModelVersion.V5
        att = {f"mix_{s}": vecs("blocks.{i}.att.time_mix_" + s)
               for s in ("kvrg" if v5 else "kvr")}
        if v5:  # per head, the decay activated at load: exp(-exp(raw))
            att["time_decay"] = dev(np.exp(-np.exp(raw_decay)).reshape(L, H, hs))
            att["time_first"] = vecs("blocks.{i}.att.time_first").reshape(L, H, hs)
            att["gn"] = ln("blocks.{i}.att.ln_x")
        else:  # per channel, the decay as -exp(raw)
            att["time_decay"] = dev(-np.exp(raw_decay))
            att["time_first"] = vecs("blocks.{i}.att.time_first")
        att.update(_att_matrices(mats, gate=v5))
    if info.version != ModelVersion.V7:
        ffn = {
            "mix_k": vecs("blocks.{i}.ffn.time_mix_k"),
            "mix_r": vecs("blocks.{i}.ffn.time_mix_r"),
            "Wk": mats("blocks.{i}.ffn.key.weight"),
            "Wv": mats("blocks.{i}.ffn.value.weight", discounted=True),
            "Wr": mats("blocks.{i}.ffn.receptance.weight"),
        }
    blocks = {"ln1": ln("blocks.{i}.ln1"), "ln2": ln("blocks.{i}.ln2"), "att": att,
              "ffn": ffn}
    if _has_list(blocks):
        blocks = [_layer_slice(blocks, i) for i in range(L)]
    params = {
        "emb": dev(_np(reader, "emb.weight", np.float16)),
        "ln0": {"w": dev(vector("blocks.0.ln0.weight")),
                "b": dev(vector("blocks.0.ln0.bias"))},
        "ln_out": {"w": dev(vector("ln_out.weight")),
                   "b": dev(vector("ln_out.bias"))},
        "head": matrix("head.weight"),
        "blocks": blocks,
    }
    return info, params


def _att_matrices(mats, gate: bool) -> dict:
    """The attention matrices of RWKV-6, -5 (``gate``) and -4."""
    names = ("key", "value", "receptance") + (("gate",) if gate else ())
    out = {"W" + n[0]: mats(f"blocks.{{i}}.att.{n}.weight") for n in names}
    out["Wo"] = mats("blocks.{i}.att.output.weight", discounted=True)
    return out


def _v7_blocks(reader, info, vector, matrix_f32, to_dtype, dev, vecs, mats, adapters, ln):
    """RWKV-7's attention and FFN stacks (``load_model``'s helpers)."""
    C, L, H, hs = info.num_emb, info.num_layer, info.num_head, info.head_size

    def v7_vec(i, s, default=None):
        name = f"blocks.{i}.att.{s}"
        if reader.contains(name):
            return vector(name)
        if default is not None:
            return default
        raise TensorNotFound(name)

    zeros_c = np.zeros(C, np.float32)
    dv = info.custom.v or 1
    v1 = [np.zeros((dv, C), np.float32) if i == 0
          else matrix_f32(f"blocks.{i}.att.v1") for i in range(L)]
    v2 = [np.zeros((C, dv), np.float32) if i == 0
          else matrix_f32(f"blocks.{i}.att.v2") for i in range(L)]
    att = {
        **{f"x_{s}": vecs("blocks.{i}.att.x_" + s) for s in "rwkvag"},
        "w0": vecs("blocks.{i}.att.w0"),
        "a0": vecs("blocks.{i}.att.a0"),
        "v0": dev(np.stack([v7_vec(i, "v0", zeros_c if i == 0 else None)
                            for i in range(L)])),
        "w1": adapters("blocks.{i}.att.w1"),
        "w2": adapters("blocks.{i}.att.w2"),
        "a1": adapters("blocks.{i}.att.a1"),
        "a2": adapters("blocks.{i}.att.a2"),
        "g1": adapters("blocks.{i}.att.g1"),
        "g2": adapters("blocks.{i}.att.g2"),
        "v1": to_dtype(np.stack(v1)),
        "v2": to_dtype(np.stack(v2)),
        "r_k": dev(np.stack([_np(reader, f"blocks.{i}.att.r_k").reshape(H, hs)
                             for i in range(L)])),
        "k_k": vecs("blocks.{i}.att.k_k"),
        "k_a": vecs("blocks.{i}.att.k_a"),
        "gn": ln("blocks.{i}.att.ln_x"),
        "Wk": mats("blocks.{i}.att.key.weight"),
        "Wv": mats("blocks.{i}.att.value.weight"),
        "Wr": mats("blocks.{i}.att.receptance.weight"),
        "Wo": mats("blocks.{i}.att.output.weight", discounted=True),
    }
    # the six token-shift mixes stacked for one fused lerp: [L, 6, C]
    att["x_stack"] = torch.stack([att[f"x_{s}"] for s in "rwkvag"], dim=1)
    ffn = {
        "x_k": vecs("blocks.{i}.ffn.x_k"),
        "Wk": mats("blocks.{i}.ffn.key.weight"),
        "Wv": mats("blocks.{i}.ffn.value.weight", discounted=True),
    }
    return att, ffn
