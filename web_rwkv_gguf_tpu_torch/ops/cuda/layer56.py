"""The whole-stack RWKV-6, -5 and -4 decode step (T = 1) as one kernel
launch.

``layer_scan56`` runs every layer of one decode token for B ≤
``MAX_SCAN_BATCH`` lanes in one cooperative launch of
``csrc/layer56.cu``; ``layer_scan56_plain`` computes the same function
with plain PyTorch ops. Both take the stacked blocks of
:func:`prep_decode56`, the counterpart of the JAX package's
``ops/pallas/layer56.prep_decode56``: views of the loaded layer-stacked
parameters, tagged with the model's ``version`` (6, 5 or 4); for version
6 with the four adapters (``tm_w1`` ``[L, 5R, C]``, ``tm_w2`` ``[L, 5,
C, R]``, ``td_w1`` ``[L, D, C]``, ``td_w2`` ``[L, C, D]``) in bf16.

Each layer matrix is a kernel slot in one of the forms of
``layer7.stack_matrix`` (Q4_K, Q5_K / Q2_K or Q6_K / Q3_K native
factors, f32 group scales over byte codes or nibbles, the engine's Int8,
or dense bf16), picked per slot at run time.

Numerics follow the JAX kernel at its defaults: every quantized matrix
multiplies the bf16-rounded input by its exact f32 weight (the gemv
class, at every B), a dense bf16 one by its bf16 weight, the adapters
take bf16 operands with f32 products and round their tanh outputs to
bf16 before the up product, the rest is f32. Versions 6 and 5 write their states as the JAX kernel's blend ``S +
m·(S_n − S)``, in the form ``m·S_n + (1 − m)·S`` that is exact for a
mask of 0 or 1; version 4 writes aa, bb and pp by a select, as the JAX
kernel does (pp starts at ``F32_MIN``). A masked lane's x is
unspecified.

With ``first_layer`` both run a contiguous slice of the stack
(:func:`mega_layers`) from that global layer, so the rescale stays
aligned, as the JAX kernel's ``goff`` keeps it.

The kernel (its header comment says more) runs every layer matrix and the
two dense adapters of version 6 as tensor-core items of
``csrc/stack_mma.cuh`` through ``csrc/stack_phase.cuh``, the code it
shares with ``layer7.cu``: a 16-row tile over a K-slice of up to 2048
elements, one block an item, each block's weights streaming through a
ring of buffers in shared memory by TMA bulk copies issued items ahead,
across the grid barriers (at B ≤ 2, Wo and the FFN value one warp a
row instead). A matrix whose K is split adds its slices
partial sums in slice order (scratch sized here from an upper bound the
kernel checks, and per-tile counters kept zero on the card,
``layer7._counters``, the same buffers as row 4's). The attention output
``y`` and the FFN key's ``khid`` are stored in the staged k order, which
``staged=`` hands back in logical order. Its time on the H100 is each
item's chain of loads, products and waits, not bytes (PERF.md).

On a CUDA tensor :func:`layer_scan56` launches the kernel or raises;
only a tensor on the CPU takes the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .. import basic as B_
from .. import wkv as W
from . import build
from .layer7 import (MAX_SCAN_BATCH, _counters, check_operands, mega_layers, slot_gemv_plain,
                     slot_operands, stack_matrix, unstage)

__all__ = ["MAX_SCAN_BATCH", "PHASES", "layer_scan56", "layer_scan56_plain", "mega_layers",
           "prep_decode56", "replay_staged"]

HEAD_SIZE = 64  # the head size the kernel takes (versions 6 and 5)
# the phases of a layer between grid barriers, in order, by version
PHASES = {
    6: ("LN1+ddlerp down", "mixes", "r/k/v/g+decay down", "decay up+attention", "Wo",
        "LN2+FFN key+receptance", "FFN value"),
    5: ("LN1+mixes+r/k/v/g", "attention+gn+gate", "Wo", "LN2+FFN key+receptance",
        "FFN value"),
    4: ("LN1+mixes+r/k/v", "WKV", "Wo", "LN2+FFN key+receptance", "FFN value"),
}
_ATT = {6: ("Wr", "Wk", "Wv", "Wg", "Wo"), 5: ("Wr", "Wk", "Wv", "Wg", "Wo"),
        4: ("Wr", "Wk", "Wv", "Wo")}
# the layer matrices by version, as (part, name)
_MATRICES = {v: tuple(("att", n) for n in names) + (("ffn", "Wk"), ("ffn", "Wv"), ("ffn", "Wr"))
             for v, names in _ATT.items()}
_FACTORS = ("codes", "p1", "p2", "d8", "dm8")  # a matrix slot's operands
# the per-layer vectors by version, besides the FFN's mixes
_VECS = {6: ("mix_x", "time_decay", "time_first"),
         5: ("mix_k", "mix_v", "mix_r", "mix_g", "time_decay", "time_first"),
         4: ("mix_k", "mix_v", "mix_r", "time_decay", "time_first")}
_STATE = {6: ("att_shift", "wkv", "ffn_shift"), 5: ("att_shift", "wkv", "ffn_shift"),
          4: ("att_shift", "aa", "bb", "pp", "ffn_shift")}


def prep_decode56(params: dict, info) -> dict | None:
    """The stacked decode blocks of a loaded RWKV-6, -5 or -4 model, or
    None when the model is not one the kernel takes: another version,
    per-layer (list) blocks, a layer matrix of a form
    ``layer7.stack_matrix`` does not take, C or the FFN width not a
    multiple of 256, a
    head size other than 64 (versions 6 and 5; version 4 has one "head"
    of width C), or an adapter rank that is not a multiple of 8 (version
    6)."""
    version = {"v6": 6, "v5": 5, "v4": 4}.get(info.version.value)
    blocks = params.get("blocks")
    if version is None or not isinstance(blocks, dict):
        return None
    C, H, hs = info.num_emb, info.num_head, info.head_size
    att, ffn = blocks["att"], blocks["ffn"]
    hidden = ffn["Wk"].shape[0]
    R, D = (att["tm_w1"].shape[-2] // 5, att["td_w1"].shape[-2]) if version == 6 else (0, 0)
    if (C % 256 or hidden % 256 or R % 8 or D % 8
            or (version != 4 and (hs != HEAD_SIZE or C != H * hs))):
        return None
    mats, forms = {}, {}
    for part, name in _MATRICES[version]:
        slot = stack_matrix(blocks[part][name])
        if slot is None:
            return None
        forms[f"{part}.{name}"], mats[f"{part}.{name}"] = slot
    mega = {
        "version": version, "L": info.num_layer, "C": C, "H": H, "hs": hs, "hidden": hidden,
        "R": R, "D": D,
        "ln1": (blocks["ln1"]["w"], blocks["ln1"]["b"]),
        "ln2": (blocks["ln2"]["w"], blocks["ln2"]["b"]),
        "vecs": {**{k: att[k] for k in _VECS[version]}, "ffn_mk": ffn["mix_k"],
                 "ffn_mr": ffn["mix_r"]},
        "mats": mats,  # per slot: its five operands (layer7.stack_matrix)
        "forms": forms,  # per slot: its descriptor
    }
    if version != 4:
        mega["gn"] = (att["gn"]["w"], att["gn"]["b"])
    if version == 6:
        mega["time_mix"] = att["time_mix"]
        mega.update({k: att[k].to(torch.bfloat16) for k in ("tm_w1", "tm_w2", "td_w1", "td_w2")})
    return mega


def _bf16_dot(x, w):
    """``x`` rounded to bf16 against the bf16 rows of ``w``, f32 products."""
    return x.to(torch.bfloat16).float() @ w.float().T


# The attention of one layer i by version: the input to Wo and the new
# WKV state; ``mat(name, x)`` is layer i's quantized product.
def _att_v6(mega, state, i, mat, xx, sh, m, eps_gn):
    vec = mega["vecs"]
    wx, kx, vx, rx, gx = B_.ddlerp(xx[:, None], sh, vec["mix_x"][i], mega["time_mix"][i],
                                   mega["tm_w1"][i], mega["tm_w2"][i])[:, 0].unbind(1)
    r, k, v, g = mat("att.Wr", rx), mat("att.Wk", kx), mat("att.Wv", vx), mat("att.Wg", gx)
    dz = torch.tanh(_bf16_dot(wx, mega["td_w1"][i]))
    w = B_.stable_exp(_bf16_dot(dz, mega["td_w2"][i]) + vec["time_decay"][i])
    return _att_heads(mega, state, i, r, k, v, g, w, m, eps_gn)


def _att_v5(mega, state, i, mat, xx, sh, m, eps_gn):
    vec = mega["vecs"]
    rx, kx, vx, gx = (B_.lerp(sh, xx, vec["mix_" + s][i]) for s in "rkvg")
    r, k, v, g = mat("att.Wr", rx), mat("att.Wk", kx), mat("att.Wv", vx), mat("att.Wg", gx)
    w = vec["time_decay"][i].reshape(1, -1)  # static, activated at load
    return _att_heads(mega, state, i, r, k, v, g, w, m, eps_gn)


def _att_heads(mega, state, i, r, k, v, g, w, m, eps_gn):
    """The matrix-state WKV step of versions 6 and 5 (w activated, per
    lane or static), the group norm and the silu gate."""
    bsz, C = r.shape
    H = mega["H"]

    def heads(t):
        return t.reshape(t.shape[0], H, -1)

    S = state["wkv"][i].float()
    kv = heads(k)[..., :, None] * heads(v)[..., None, :]
    y0 = torch.einsum("bhk,bhkv->bhv", heads(r),
                      mega["vecs"]["time_first"][i].float()[..., None] * kv + S)
    s_n = heads(w)[..., None] * S + kv
    mm = m[:, :, None, None]
    y = B_.group_norm(y0.reshape(bsz, C), mega["gn"][0][i], mega["gn"][1][i], H, eps_gn)
    return y * (g * torch.sigmoid(g)), {"wkv": mm * s_n + (1 - mm) * S}


def _att_v4(mega, state, i, mat, xx, sh, m, eps_gn):
    vec = mega["vecs"]
    rx, kx, vx = (B_.lerp(sh, xx, vec["mix_" + s][i]) for s in "rkv")
    r, k, v = mat("att.Wr", rx), mat("att.Wk", kx), mat("att.Wv", vx)
    st = torch.stack([state[s][i].float() for s in ("aa", "bb", "pp")], dim=-1)
    y, st = W.wkv4_step(st, k[:, None], v[:, None], r[:, None], vec["time_first"][i],
                        vec["time_decay"][i], m > 0)
    return y[:, 0], {"aa": st[..., 0], "bb": st[..., 1], "pp": st[..., 2]}


_ATT_PLAIN = {6: _att_v6, 5: _att_v5, 4: _att_v4}


def layer_scan56_plain(mega, state, x, mask, rescale, eps_ln, eps_gn, first_layer=0,
                       staged=None):
    """Plain version of :func:`layer_scan56`; ``staged`` as there."""
    version, L = mega["version"], mega["L"]
    vec = mega["vecs"]
    m = mask.float()[:, None]
    x = x.float()
    news = {k: [] for k in _STATE[version]}
    io = {}  # the last layer's matrices: name -> (input, product)

    for i in range(L):
        def mat(name, xin, i=i):
            io[name] = (xin, slot_gemv_plain(mega["forms"][name], mega["mats"][name], i, xin))
            return io[name][1]

        xx = B_.layer_norm(x, mega["ln1"][0][i], mega["ln1"][1][i], eps_ln)
        sh = state["att_shift"][i]
        y, new_wkv = _ATT_PLAIN[version](mega, state, i, mat, xx, sh, m, eps_gn)
        x = x + mat("att.Wo", y)
        xx2 = B_.layer_norm(x, mega["ln2"][0][i], mega["ln2"][1][i], eps_ln)
        fsh = state["ffn_shift"][i]
        if version == 6:  # reversed mixes
            kx2, rx2 = B_.lerp(xx2, fsh, vec["ffn_mk"][i]), B_.lerp(xx2, fsh, vec["ffn_mr"][i])
        else:
            kx2, rx2 = B_.lerp(fsh, xx2, vec["ffn_mk"][i]), B_.lerp(fsh, xx2, vec["ffn_mr"][i])
        vf = mat("ffn.Wv", B_.squared_relu(mat("ffn.Wk", kx2)))
        x = x + torch.sigmoid(mat("ffn.Wr", rx2)) * vf
        if rescale and (first_layer + i + 1) % rescale == 0:
            x = x * 0.5
        news["att_shift"].append(m * xx + (1 - m) * sh)
        news["ffn_shift"].append(m * xx2 + (1 - m) * fsh)
        for k, a in new_wkv.items():
            news[k].append(a)
    if staged is not None:
        rkvg = [io[f"att.W{p}"][1] if f"att.W{p}" in io else torch.zeros_like(x) for p in "rkvg"]
        staged.update(rkvg=torch.stack(rkvg), y=io["att.Wo"][0].to(torch.bfloat16),
                      khid=io["ffn.Wv"][0].to(torch.bfloat16), rf=io["ffn.Wr"][1])
    return x, {k: torch.stack(v) for k, v in news.items()}


def replay_staged(mega, i, state, x, mask, eps_ln, eps_gn, staged):
    """Layer i of ``mega`` replayed in plain PyTorch from the operands a
    one-layer launch of it staged (``staged`` of :func:`layer_scan56`),
    for checks that hold each staged operand against what the kernel's own
    earlier ones make of it: ``y`` (bf16) from the staged r/k/v/g products
    and the layer's input ``state`` (versions 6 and 5; None for version 4,
    which stages no v), ``khid`` (bf16) from ``x + Wo·y`` with the staged
    y, and ``x`` (f32, no rescale) from the staged y, khid and FFN
    receptance. Each differs from the staged one by the order of f32 sums
    alone, and by the bf16 roundings that order flips."""
    version, vec = mega["version"], mega["vecs"]

    def mat(name, a):
        return slot_gemv_plain(mega["forms"][name], mega["mats"][name], i, a.float())

    y = None
    if version != 4:
        r, k, v, g = staged["rkvg"].float().unbind(0)
        # the decay only moves the new state, not y
        y = _att_heads(mega, state, i, r, k, v, g, torch.ones_like(r), mask.float()[:, None],
                       eps_gn)[0].to(torch.bfloat16)
    x_mid = x.float() + mat("att.Wo", staged["y"])
    xx2 = B_.layer_norm(x_mid, mega["ln2"][0][i], mega["ln2"][1][i], eps_ln)
    fsh = state["ffn_shift"][i]
    mk = vec["ffn_mk"][i]
    kx2 = B_.lerp(xx2, fsh, mk) if version == 6 else B_.lerp(fsh, xx2, mk)
    khid = B_.squared_relu(mat("ffn.Wk", kx2)).to(torch.bfloat16)
    x_out = x_mid + torch.sigmoid(staged["rf"].float()) * mat("ffn.Wv", staged["khid"])
    return {"y": y, "khid": khid, "x": x_out}


@functools.cache
def _fn():
    fn = build.load("layer56").layer_scan56
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


# the kernel's pointer operands in its order (csrc/layer56.cu, layer_scan56);
# a name a version does not use goes as a null pointer
_MATRIX_SLOTS = ("att.Wr", "att.Wk", "att.Wv", "att.Wg", "att.Wo", "ffn.Wk", "ffn.Wv", "ffn.Wr")
_ORDER = (
    "ln1_w", "ln1_b", "ln2_w", "ln2_b", "mix_x", "time_decay", "time_first", "gn_w", "gn_b",
    "ffn_mk", "ffn_mr", "time_mix", "tm_w1", "tm_w2", "td_w1", "td_w2",
    *(f"{m}.{f}" for m in _MATRIX_SLOTS for f in _FACTORS),
    "att_shift", "ffn_shift", "wkv", "att_shift_out", "ffn_shift_out", "wkv_out", "mask", "x",
    "xx", "z", "mixed", "rkvg", "dz", "y", "khid", "rf", "phase_ns",
    "mix_k", "mix_v", "mix_r", "mix_g", "aa", "bb", "pp", "aa_out", "bb_out", "pp_out",
    "part", "cnt",
)


def _operands(mega, dev):
    """The kernel's parameter operands by name (an array a matrix form
    lacks is left out: a null pointer), each checked against the shape
    and type the kernel reads."""
    version, L, C, hidden, R, D = (mega[k] for k in ("version", "L", "C", "hidden", "R", "D"))
    f32, bf = (torch.float32,), (torch.bfloat16,)
    want = {"ln1_w": (mega["ln1"][0], f32, L * C), "ln1_b": (mega["ln1"][1], f32, L * C),
            "ln2_w": (mega["ln2"][0], f32, L * C), "ln2_b": (mega["ln2"][1], f32, L * C)}
    want.update({k: (a, f32, L * C) for k, a in mega["vecs"].items()})
    if version != 4:
        want.update({"gn_w": (mega["gn"][0], f32, L * C), "gn_b": (mega["gn"][1], f32, L * C)})
    if version == 6:
        want.update({"time_mix": (mega["time_mix"], f32, L * 5 * C),
                     "tm_w1": (mega["tm_w1"], bf, L * 5 * R * C),
                     "tm_w2": (mega["tm_w2"], bf, L * 5 * C * R),
                     "td_w1": (mega["td_w1"], bf, L * D * C),
                     "td_w2": (mega["td_w2"], bf, L * C * D)})
    for name, ops in mega["mats"].items():
        m, k = {"ffn.Wk": (hidden, C), "ffn.Wv": (C, hidden)}.get(name, (C, C))
        for f, w in zip(_FACTORS, slot_operands(mega["forms"][name], ops, L, m, k)):
            want[f"{name}.{f}"] = w
    check_operands("layer_scan56", want.values(), dev)
    return {name: a for name, (a, _, _) in want.items() if a is not None}


def layer_scan56(mega, state, x, mask, rescale, eps_ln, eps_gn, first_layer=0,
                 phase_ns=None, staged=None):
    """One decode token through every layer of ``mega``.

    ``state``: layer-stacked ``att_shift`` / ``ffn_shift`` ``[L, B, C]``
    and, for versions 6 and 5, ``wkv`` ``[L, B, H, K, V]``, for version 4
    ``aa`` / ``bb`` / ``pp`` ``[L, B, C]``; ``x`` ``[B, C]`` the
    ln0-normalized input; ``mask`` ``[B]`` (0 freezes a lane's state);
    ``rescale`` halves the residual after every ``rescale``-th layer
    (None: never), counted from global layer ``first_layer`` (the index
    of ``mega``'s first layer when it is a slice). Returns ``(x [B, C],
    new_state)`` in f32; the input state is left as it was.
    ``phase_ns``, an int64 tensor of ``1 + P·L`` on the card (P =
    ``len(PHASES[version])``: 7, 5 or 4), receives the device clock (ns)
    at the start and after each phase of every layer (the kernel only,
    the plain version leaves it untouched). ``staged``, a dict, receives
    the last layer's operands as the kernel stages them between phases:
    ``rkvg`` ``[4, B, C]`` the f32 r/k/v/g products (version 4: r and k;
    the rest unspecified), ``y`` the bf16 input to Wo, ``khid`` the bf16
    input to the FFN value and ``rf`` the f32 FFN receptance product (for
    checks that replay a layer from them)."""
    if not x.is_cuda:
        return layer_scan56_plain(mega, state, x, mask, rescale, eps_ln, eps_gn, first_layer,
                                  staged)
    version, L, C, H, hs, hidden, R, D = (
        mega[k] for k in ("version", "L", "C", "H", "hs", "hidden", "R", "D"))
    bsz = x.shape[0]
    if (C % 256 or hidden % 256 or not 1 <= bsz <= MAX_SCAN_BATCH or first_layer < 0
            or (version != 4 and hs != HEAD_SIZE) or (version == 6 and (R % 8 or D % 8))):
        raise ValueError(f"layer_scan56: the kernel takes C and hidden multiples of 256, "
                         f"1..{MAX_SCAN_BATCH} lanes, head size {HEAD_SIZE} (versions 6 "
                         f"and 5) and ranks multiples of 8 (version 6); got version "
                         f"{version}, head size {hs}, C={C}, hidden={hidden}, ranks {R}/{D}, "
                         f"B={bsz}, first layer {first_layer}")
    dev = x.device
    ptr = {k: a.data_ptr() for k, a in _operands(mega, dev).items()}
    want = {key: (L, bsz, C) for key in _STATE[version]}
    if version != 4:
        want["wkv"] = (L, bsz, H, hs, hs)
    st, out = {}, {}
    for key, shape in want.items():
        a = state.get(key)
        if a is None or tuple(a.shape) != shape or a.device != dev:
            got = "nothing" if a is None else f"{tuple(a.shape)} on {a.device}"
            raise ValueError(f"layer_scan56: state {key} must be {shape} on {dev}, got {got}")
        st[key] = a.float().contiguous()
        out[key] = torch.empty_like(st[key])
        ptr[key], ptr[key + "_out"] = st[key].data_ptr(), out[key].data_ptr()
    if tuple(x.shape) != (bsz, C) or tuple(mask.shape) != (bsz,) or mask.device != dev:
        raise ValueError(f"layer_scan56: x must be [{bsz}, {C}] and mask [{bsz}] on {dev}")
    x_io = x.float().contiguous().clone()
    m = mask.float().contiguous()
    bf, f32 = torch.bfloat16, torch.float32
    scratch = {"rkvg": torch.empty(4, bsz, C, dtype=f32, device=dev),  # r, k, v, g
               "y": torch.empty(bsz, C, dtype=bf, device=dev),
               "khid": torch.empty(bsz, hidden, dtype=bf, device=dev),
               "rf": torch.empty(bsz, C, dtype=f32, device=dev)}    # FFN receptance
    if version == 6:
        scratch.update({"xx": torch.empty(bsz, C, dtype=f32, device=dev),
                        "z": torch.empty(bsz, 5 * R, dtype=bf, device=dev),
                        "mixed": torch.empty(5, bsz, C, dtype=bf, device=dev),
                        "dz": torch.empty(bsz, D, dtype=bf, device=dev)})
    # split-K scratch, at least what the kernel's plan needs (it checks): a
    # phase's rows (V6's r/k/v/g and decay down, the FFN key and receptance,
    # the time-mix down, each rounded up to 16-row tiles) in K-slices of 256
    # or more
    rows = max(4 * C + D + 16, hidden + C, 5 * R + 16)
    scratch["part"] = torch.empty(bsz * C * rows // 256, dtype=f32, device=dev)
    ptr.update({k: a.data_ptr() for k, a in scratch.items()})
    ptr["mask"], ptr["x"] = m.data_ptr(), x_io.data_ptr()
    if phase_ns is not None:
        n = 1 + len(PHASES[version]) * L
        if phase_ns.dtype != torch.int64 or phase_ns.numel() != n or phase_ns.device != dev:
            raise ValueError(f"layer_scan56: phase_ns must be int64 [{n}] on {dev}")
        ptr["phase_ns"] = phase_ns.data_ptr()
    with torch.cuda.device(dev):
        cnt = _counters(dev, -(-rows // 16))
        ptr["cnt"] = cnt.data_ptr()
        ptrs = [ptr.get(name, 0) for name in _ORDER]
        ints = [L, bsz, C, H, hidden, R, D, rescale or 0, first_layer, version,
                *(mega["forms"].get(m, 0) for m in _MATRIX_SLOTS), scratch["part"].numel(),
                cnt.numel()]
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                    (ctypes.c_float * 2)(eps_ln, eps_gn), stream)
    layer_scan56.launches += 1
    layer_scan56.shapes[(version, L, bsz, C)] += 1
    if err:
        raise RuntimeError(f"layer_scan56 launch failed: CUDA error {err}")
    if staged is not None:  # y and khid are stored in the staged order
        staged.update(rkvg=scratch["rkvg"], y=unstage(scratch["y"]),
                      khid=unstage(scratch["khid"]), rf=scratch["rf"])
    return x_io, out


layer_scan56.launches = 0
layer_scan56.shapes = collections.Counter()  # launches by (version, L, B, C)
