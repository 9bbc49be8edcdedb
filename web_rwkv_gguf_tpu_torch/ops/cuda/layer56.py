"""The whole-stack RWKV-6 decode step (T = 1) as one kernel launch.

``layer_scan56`` runs every layer of one V6 decode token for B ≤
``MAX_SCAN_BATCH`` lanes in one cooperative launch of
``csrc/layer56.cu``; ``layer_scan56_plain`` computes the same function
with plain PyTorch ops. Both take the stacked blocks of
:func:`prep_decode56`, the counterpart of the JAX package's
``ops/pallas/layer56.prep_decode56`` for version 6: views of the loaded
layer-stacked parameters, with the four adapters (``tm_w1`` ``[L, 5R,
C]``, ``tm_w2`` ``[L, 5, C, R]``, ``td_w1`` ``[L, D, C]``, ``td_w2``
``[L, C, D]``) in bf16.

Numerics follow the JAX kernel at its defaults: every quantized matrix
multiplies the bf16-rounded input by its exact f32 weight (the gemv
class, at every B), the adapters take bf16 operands with f32 products
and round their tanh outputs to bf16 before the up product, the rest is
f32. The states are written as the JAX kernel's blend ``S + m·(S_n −
S)``, in the form ``m·S_n + (1 − m)·S`` that is exact for a mask of 0
or 1; a masked lane's x is unspecified.

With ``first_layer`` both run a contiguous slice of the stack
(:func:`mega_layers`) from that global layer, so the rescale stays
aligned, as the JAX kernel's ``goff`` keeps it.

On a CUDA tensor :func:`layer_scan56` launches the kernel or raises;
only a tensor on the CPU takes the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .. import basic as B_
from . import build
from .layer7 import MAX_SCAN_BATCH, mega_layers
from .matmul import q4k_gemv_plain

__all__ = ["MAX_SCAN_BATCH", "PHASES", "layer_scan56", "layer_scan56_plain", "mega_layers",
           "prep_decode56"]

HEAD_SIZE = 64  # the head size the kernel takes
PHASES = ("LN1+ddlerp down", "mixes", "r/k/v/g+decay down", "decay up+attention", "Wo",
          "LN2+FFN key+receptance", "FFN value")  # grid barriers per layer, in order
_MATRICES = (("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wg"), ("att", "Wo"),
             ("ffn", "Wk"), ("ffn", "Wv"), ("ffn", "Wr"))
_FACTORS = ("codes", "sc6", "mn6", "d8", "dm8")


def prep_decode56(params: dict, info) -> dict | None:
    """The stacked V6 decode blocks of a loaded model, or None when the
    model is not one the kernel takes: not RWKV-6, per-layer (list)
    blocks, a layer matrix that is not Q4_K with whole 256-element
    super-blocks, a head size other than 64, C or the FFN width not a
    multiple of 256, or an adapter rank that is not a multiple of 8."""
    blocks = params.get("blocks")
    if info.version.value != "v6" or not isinstance(blocks, dict):
        return None
    C, H, hs = info.num_emb, info.num_head, info.head_size
    att, ffn = blocks["att"], blocks["ffn"]
    hidden = ffn["Wk"].shape[0]
    R, D = att["tm_w1"].shape[-2] // 5, att["td_w1"].shape[-2]
    if hs != HEAD_SIZE or C != H * hs or C % 256 or hidden % 256 or R % 8 or D % 8:
        return None
    mats = {}
    for part, name in _MATRICES:
        m = blocks[part][name]
        if getattr(m, "kind", None) != "qk" or "sc6" not in m.arrays:
            return None
        mats[f"{part}.{name}"] = tuple(m.arrays[k] for k in _FACTORS)
    bf = torch.bfloat16
    return {
        "L": info.num_layer, "C": C, "H": H, "hs": hs, "hidden": hidden, "R": R, "D": D,
        "ln1": (blocks["ln1"]["w"], blocks["ln1"]["b"]),
        "ln2": (blocks["ln2"]["w"], blocks["ln2"]["b"]),
        "vecs": {"mix_x": att["mix_x"], "time_decay": att["time_decay"],
                 "time_first": att["time_first"], "ffn_mk": ffn["mix_k"],
                 "ffn_mr": ffn["mix_r"]},
        "gn": (att["gn"]["w"], att["gn"]["b"]),
        "time_mix": att["time_mix"],
        **{k: att[k].to(bf) for k in ("tm_w1", "tm_w2", "td_w1", "td_w2")},
        "mats": mats,
    }


def _bf16_dot(x, w):
    """``x`` rounded to bf16 against the bf16 rows of ``w``, f32 products."""
    return x.to(torch.bfloat16).float() @ w.float().T


def layer_scan56_plain(mega, state, x, mask, rescale, eps_ln, eps_gn, first_layer=0):
    """Plain version of :func:`layer_scan56`."""
    L, H, R = mega["L"], mega["H"], mega["R"]
    vec = mega["vecs"]
    m = mask.float()[:, None]
    x = x.float()
    bsz, C = x.shape
    news = {k: [] for k in ("att_shift", "wkv", "ffn_shift")}

    def heads(t):
        return t.reshape(bsz, H, -1)

    for i in range(L):
        def mat(name, xin, i=i):
            return q4k_gemv_plain(xin, *(a[i] for a in mega["mats"][name]))

        xx = B_.layer_norm(x, mega["ln1"][0][i], mega["ln1"][1][i], eps_ln)
        sh = state["att_shift"][i]
        wx, kx, vx, rx, gx = B_.ddlerp(xx[:, None], sh, vec["mix_x"][i], mega["time_mix"][i],
                                       mega["tm_w1"][i], mega["tm_w2"][i])[:, 0].unbind(1)
        r, k, v, g = mat("att.Wr", rx), mat("att.Wk", kx), mat("att.Wv", vx), mat("att.Wg", gx)
        dz = torch.tanh(_bf16_dot(wx, mega["td_w1"][i]))
        w = B_.stable_exp(_bf16_dot(dz, mega["td_w2"][i]) + vec["time_decay"][i])
        S = state["wkv"][i].float()
        kv = heads(k)[..., :, None] * heads(v)[..., None, :]
        y0 = torch.einsum("bhk,bhkv->bhv", heads(r),
                          vec["time_first"][i].float()[..., None] * kv + S)
        s_n = heads(w)[..., None] * S + kv
        mm = m[:, :, None, None]
        y = B_.group_norm(y0.reshape(bsz, C), mega["gn"][0][i], mega["gn"][1][i], H, eps_gn)
        x = x + mat("att.Wo", y * (g * torch.sigmoid(g)))
        xx2 = B_.layer_norm(x, mega["ln2"][0][i], mega["ln2"][1][i], eps_ln)
        fsh = state["ffn_shift"][i]
        kx2 = B_.lerp(xx2, fsh, vec["ffn_mk"][i])
        rx2 = B_.lerp(xx2, fsh, vec["ffn_mr"][i])
        vf = mat("ffn.Wv", B_.squared_relu(mat("ffn.Wk", kx2)))
        x = x + torch.sigmoid(mat("ffn.Wr", rx2)) * vf
        if rescale and (first_layer + i + 1) % rescale == 0:
            x = x * 0.5
        news["att_shift"].append(m * xx + (1 - m) * sh)
        news["wkv"].append(mm * s_n + (1 - mm) * S)
        news["ffn_shift"].append(m * xx2 + (1 - m) * fsh)
    return x, {k: torch.stack(v) for k, v in news.items()}


@functools.cache
def _fn():
    fn = build.load("layer56").layer_scan56
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def _operands(mega, dev):
    """The kernel's parameter operands in its order, each checked against
    the shape and type the kernel reads."""
    L, C, hidden, R, D = (mega[k] for k in ("L", "C", "hidden", "R", "D"))
    vec = mega["vecs"]
    f32, bf, u8 = torch.float32, torch.bfloat16, torch.uint8
    want = [(a, f32, L * C) for a in (*mega["ln1"], *mega["ln2"])]
    want += [(vec[k], f32, L * C) for k in ("mix_x", "time_decay", "time_first")]
    want += [(a, f32, L * C) for a in (*mega["gn"], vec["ffn_mk"], vec["ffn_mr"])]
    want.append((mega["time_mix"], f32, L * 5 * C))
    want += [(mega["tm_w1"], bf, L * 5 * R * C), (mega["tm_w2"], bf, L * 5 * C * R),
             (mega["td_w1"], bf, L * D * C), (mega["td_w2"], bf, L * C * D)]
    for part, name in _MATRICES:
        m, k = {"ffn.Wk": (hidden, C), "ffn.Wv": (C, hidden)}.get(f"{part}.{name}", (C, C))
        sizes = (m * k // 2, m * k // 32, m * k // 32, m * k // 256, m * k // 256)
        for a, dt, n in zip(mega["mats"][f"{part}.{name}"], (u8, u8, u8, f32, f32), sizes):
            want.append((a, dt, L * n))
    for a, dt, n in want:
        if a.dtype != dt or a.numel() != n or a.device != dev:
            raise ValueError(f"layer_scan56: a parameter is {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}, want {dt} of {n} elements on {dev}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError("layer_scan56: every parameter must be contiguous and "
                             "16-byte aligned")
    return [a for a, _, _ in want]


def layer_scan56(mega, state, x, mask, rescale, eps_ln, eps_gn, first_layer=0,
                 phase_ns=None):
    """One V6 decode token through every layer of ``mega``.

    ``state``: layer-stacked ``att_shift`` / ``ffn_shift`` ``[L, B, C]``
    and ``wkv`` ``[L, B, H, K, V]``; ``x`` ``[B, C]`` the ln0-normalized
    input; ``mask`` ``[B]`` (0 freezes a lane's state); ``rescale``
    halves the residual after every ``rescale``-th layer (None: never),
    counted from global layer ``first_layer`` (the index of ``mega``'s
    first layer when it is a slice). Returns ``(x [B, C], new_state)`` in
    f32; the input state is left as it was. ``phase_ns``, an int64 tensor
    of ``1 + 7·L`` on the card, receives the device clock (ns) at the
    start and after each of every layer's seven phases (:data:`PHASES`;
    the kernel only, the plain version leaves it untouched)."""
    if not x.is_cuda:
        return layer_scan56_plain(mega, state, x, mask, rescale, eps_ln, eps_gn, first_layer)
    L, C, H, hs, hidden, R, D = (mega[k] for k in ("L", "C", "H", "hs", "hidden", "R", "D"))
    bsz = x.shape[0]
    if (hs != HEAD_SIZE or C % 256 or hidden % 256 or R % 8 or D % 8
            or not 1 <= bsz <= MAX_SCAN_BATCH or first_layer < 0):
        raise ValueError(f"layer_scan56: the kernel takes head size {HEAD_SIZE}, C and "
                         f"hidden multiples of 256, ranks multiples of 8 and "
                         f"1..{MAX_SCAN_BATCH} lanes; got head size {hs}, C={C}, "
                         f"hidden={hidden}, ranks {R}/{D}, B={bsz}, first layer {first_layer}")
    dev = x.device
    ops = _operands(mega, dev)
    want = {"att_shift": (L, bsz, C), "ffn_shift": (L, bsz, C), "wkv": (L, bsz, H, hs, hs)}
    st = {}
    for key, shape in want.items():
        a = state[key]
        if tuple(a.shape) != shape or a.device != dev:
            raise ValueError(f"layer_scan56: state {key} must be {shape} on {dev}, got "
                             f"{tuple(a.shape)} on {a.device}")
        st[key] = a.float().contiguous()
    if tuple(x.shape) != (bsz, C) or tuple(mask.shape) != (bsz,) or mask.device != dev:
        raise ValueError(f"layer_scan56: x must be [{bsz}, {C}] and mask [{bsz}] on {dev}")
    out = {key: torch.empty_like(a) for key, a in st.items()}
    x_io = x.float().contiguous().clone()
    m = mask.float().contiguous()
    bf, f32 = torch.bfloat16, torch.float32
    scratch = [torch.empty(bsz, C, dtype=f32, device=dev),             # xx
               torch.empty(bsz, 5 * R, dtype=bf, device=dev),          # z
               torch.empty(5, bsz, C, dtype=bf, device=dev),           # mixed inputs
               torch.empty(4, bsz, C, dtype=f32, device=dev),          # r, k, v, g
               torch.empty(bsz, D, dtype=bf, device=dev),              # dz
               torch.empty(bsz, C, dtype=bf, device=dev),              # y
               torch.empty(bsz, hidden, dtype=bf, device=dev),         # khid
               torch.empty(bsz, C, dtype=f32, device=dev)]             # rf
    ptrs = [a.data_ptr() for a in ops] + [
        st["att_shift"].data_ptr(), st["ffn_shift"].data_ptr(), st["wkv"].data_ptr(),
        out["att_shift"].data_ptr(), out["ffn_shift"].data_ptr(), out["wkv"].data_ptr(),
        m.data_ptr(), x_io.data_ptr(), *(a.data_ptr() for a in scratch)]
    if phase_ns is not None:
        n = 1 + len(PHASES) * L
        if phase_ns.dtype != torch.int64 or phase_ns.numel() != n or phase_ns.device != dev:
            raise ValueError(f"layer_scan56: phase_ns must be int64 [{n}] on {dev}")
    ptrs.append(0 if phase_ns is None else phase_ns.data_ptr())
    ints = [L, bsz, C, H, hidden, R, D, rescale or 0, first_layer]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * 9)(*ints),
                    (ctypes.c_float * 2)(eps_ln, eps_gn), stream)
    layer_scan56.launches += 1
    layer_scan56.shapes[(L, bsz, C)] += 1
    if err:
        raise RuntimeError(f"layer_scan56 launch failed: CUDA error {err}")
    return x_io, out


layer_scan56.launches = 0
layer_scan56.shapes = collections.Counter()  # launches by (L, B, C)
