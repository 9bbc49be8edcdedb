"""The whole-stack RWKV-7 decode step (T = 1) as one kernel launch.

``layer_scan7`` runs every layer of one decode token for B ≤
``MAX_SCAN_BATCH`` lanes in one cooperative launch of
``csrc/layer7.cu``; ``layer_scan7_plain`` computes the same function
with plain PyTorch ops. Both take the stacked blocks of
:func:`prep_decode7`, the counterpart of the JAX package's
``ops/pallas/layer7.prep_decode7``: views of the loaded layer-stacked
parameters, plus the inner-LoRA pairs concatenated and rounded to bf16
(``down`` ``[L, D, C]`` = w1 | a1 | g1 | v1, ``up`` ``[L, C, D]``).

Each layer matrix is a kernel slot in one of the forms of
:func:`stack_matrix` (Q4_K, Q5_K / Q2_K or Q6_K / Q3_K native factors,
f32 group scales over byte codes or over nibbles, the engine's Int8, or
dense bf16), picked per slot at run time; the layers of one slot share
its form (the loader stacks only uniform layers).

Numerics follow the JAX kernel at its defaults: every quantized matrix
multiplies the bf16-rounded input by its exact f32 weight (the gemv
class, at every B — where the composed per-layer path sends the FFN
value matrix at B ≥ 3 to the bf16-weight GEMM), a dense bf16 matrix
multiplies it by its bf16 weight with f32 products, the LoRA pairs take
bf16 operands with f32 products, the rest is f32.

With ``v0_carry`` both run a contiguous slice of the stack
(:func:`mega_layers`), as the JAX kernel's pipeline-stage mode does.

The kernel (its header comment and ``csrc/stack_mma.cuh`` say more) runs
each matrix as items of a 16-row tile over a K-slice of at most 768
elements on the tensor cores, one block an item, each block's first item
of a phase brought into shared memory by TMA bulk copies issued phases
ahead; a matrix whose K is split adds its slices' partial sums in slice
order (scratch sized here from an upper bound, and per-tile counters kept
zero on the card, :func:`_counters`); every phase issues its input copies
in one batch after its grid barrier; at B ≤ 2, Wo and the FFN value run
one warp a row instead. Its time on the H100 is each phase's chain of
dependent steps, not bytes: the five grid barriers a layer (1.1-1.5 µs
each), the inputs' copies, each block's LayerNorm over the whole row, the
products (PERF.md).

On a CUDA tensor :func:`layer_scan7` launches the kernel or raises; only
a tensor on the CPU takes the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .. import basic as B_
from . import build
from .matmul import q4k_gemv_plain, q6k_gemv_plain, qkb_gemv_plain, qs_gemv_plain
from .wkv7 import HEAD_SIZE, att_core7_plain

MAX_SCAN_BATCH = 16  # lanes one launch takes (the JAX package's limit too)
# the phases of a layer, each ended by a grid barrier (and a phase_ns stamp)
PHASES = ("LN1+mix+r/k/v+LoRA down", "LoRA up+attention", "Wo", "LN2+mix+FFN key",
          "FFN value")
_MATRICES = (("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wo"),
             ("ffn", "Wk"), ("ffn", "Wv"))
# the forms of a matrix slot (csrc/decode_common.cuh, MatForm)
FORM_Q4K, FORM_QKB, FORM_QS, FORM_Q6K, FORM_QS_NIB, FORM_DENSE = range(6)
SIGNED_BIT, GS_SHIFT = 3, 4  # a slot descriptor is form | signed << 3 | gs << 4
# the group sizes each quantized form's kernel row takes
_FORM_GS = {FORM_Q4K: (32,), FORM_QS_NIB: (32,), FORM_Q6K: (16,), FORM_QKB: (16, 32),
            FORM_QS: (16, 32)}


# The split-K tile counters, one buffer a device and size (a size is a
# model's widths). It is made zero once and every launch leaves it zero (a
# tile's last block resets its counter), so a launch needs no memset and
# replays unchanged in a CUDA graph, and no buffer is ever freed under a
# graph that holds it. Launches that share a buffer therefore run one at a
# time (on one stream, as the Engine issues them).
_COUNTERS: dict = {}


def _counters(dev, n: int):
    """``n`` zero int32 counters on ``dev``, the same buffer for every
    launch there at that size (of ``layer_scan7`` and ``layer56.
    layer_scan56`` alike: each leaves it zero)."""
    buf = _COUNTERS.get((dev, n))
    if buf is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a whole-stack decode kernel: launch once outside a CUDA graph "
                               "capture first (its split-K counters are made zero then)")
        buf = _COUNTERS[(dev, n)] = torch.zeros(n, dtype=torch.int32, device=dev)
    return buf


def unstage(t):
    """A ``[B, K]`` operand the kernels store in the staged order (each run
    of 4 elements as 0, 2, 1, 3) in logical order."""
    b, k = t.shape
    return t.view(b, k // 4, 4)[:, :, [0, 2, 1, 3]].reshape(b, k)


def descriptor(form: int, signed: int, gs: int) -> int:
    """A matrix slot's descriptor (decode_common.cuh, MatForm)."""
    return form | signed << SIGNED_BIT | gs << GS_SHIFT


def slot_form(desc: int) -> int:
    return desc & ((1 << SIGNED_BIT) - 1)


def stack_matrix(m):
    """A layer-stacked matrix as a slot of the whole-stack kernels:
    ``(descriptor, (codes, p1, p2, d8, dm8))``, None for an array the form
    lacks (decode_common.cuh, MatForm) — or None for a matrix they do not
    take. They take, as the JAX package's ``_prep_matrix`` does: Q4_K
    with whole super-blocks (native factors); Q5_K / Q2_K and Q6_K / Q3_K
    with whole super-blocks (native factors: codes, q6s and q6d for the
    latter); f32 group scales over byte codes (Q8_0, Q5_0, Q5_1, and Q4_1 /
    Q4_0 bytes) and over split-halves nibbles (Q4_0 / Q4_1 at K % 64 == 0,
    Q4_K rows without whole super-blocks); the engine's Int8 (its f32-scale
    form in 128-groups, formed here as ``_prep_matrix`` forms it: s = (mx −
    mn)/255, and −mn for the mins); and dense bf16 weights ``[L, M, K]``
    with M % 8 == 0. Not NF4 / SF4, which the JAX package's whole-stack
    kernels do not take either, and not dense f32 weights: the JAX slot
    rounds those to bf16, which the port's f32 reference class does not
    do, so an f32 stack decodes layer by layer."""
    kind, a = getattr(m, "kind", None), getattr(m, "arrays", {})
    if kind == "dense":
        w = a["w"]
        if w.dtype != torch.bfloat16 or w.dim() != 3 or w.shape[1] % 8:
            return None
        return descriptor(FORM_DENSE, 0, 0), (w, None, None, None, None)
    if kind == "int8":
        mn, mx = a["mn"].float(), a["mx"].float()
        return (descriptor(FORM_QS, 0, 128),
                (a["codes"], ((mx - mn) / 255.0).contiguous(), (-mn).contiguous(), None, None))
    codes = a.get("codes")
    if kind == "qk" and "sc6" in a:
        form, gs, keys = FORM_Q4K, 32, ("sc6", "mn6", "d8", "dm8")
    elif kind == "qk" and "scales" in a:
        form, gs, keys = FORM_QS_NIB, 2 * codes.shape[-1] // a["scales"].shape[-1], (
            "scales", "mins", None, None)
    elif kind == "qk_b" and "sc6" in a:
        form, gs, keys = FORM_QKB, codes.shape[-1] // a["sc6"].shape[-1], (
            "sc6", "mn6", "d8", "dm8")
    elif kind == "qk_nomin" and "q6s" in a:
        form, gs, keys = FORM_Q6K, codes.shape[-1] // a["q6s"].shape[-1], (
            "q6s", None, "q6d", None)
    elif kind in ("qk_b", "qk_nomin") and "scales" in a:
        form, gs, keys = FORM_QS, codes.shape[-1] // a["scales"].shape[-1], (
            "scales", "mins", None, None)
    else:
        return None
    if gs not in _FORM_GS[form]:
        return None
    signed = int(codes.dtype == torch.int8)
    return descriptor(form, signed, gs), (codes, *(a.get(k) if k else None for k in keys))


def slot_gemv_plain(desc, ops, i, x):
    """Layer i's product of a matrix slot (descriptor and operands of
    :func:`stack_matrix`) in the class its kernel row computes, in plain
    PyTorch: the gemv class of a quantized form, bf16 operands with f32
    products for a dense one."""
    codes, p1, p2, d8, dm8 = (None if t is None else t[i] for t in ops)
    form = slot_form(desc)
    if form == FORM_Q4K:
        return q4k_gemv_plain(x, codes, p1, p2, d8, dm8)
    if form == FORM_QKB:
        return qkb_gemv_plain(x, codes, p1, p2, d8, dm8)
    if form == FORM_Q6K:
        return q6k_gemv_plain(x, codes, p1, d8)
    if form == FORM_DENSE:
        return x.to(torch.bfloat16).float() @ codes.float().T
    return qs_gemv_plain(x, codes, p1, p2)


def slot_operands(desc, ops, L, m, k):
    """A matrix slot's five operands with the type(s) and element count
    the kernel reads for each (None for an absent one), for an ``[L, M,
    K]`` stack."""
    form, gs = slot_form(desc), desc >> GS_SHIFT
    f32, u8, i8 = torch.float32, torch.uint8, torch.int8
    none = (None, 0)
    if form == FORM_Q4K:
        want = ((u8, m * k // 2), (u8, m * k // 32), (u8, m * k // 32),
                (f32, m * k // 256), (f32, m * k // 256))
    elif form == FORM_QKB:
        want = ((u8, m * k), (u8, m * k // gs), (u8, m * k // gs),
                (f32, m * k // 256), (f32, m * k // 256))
    elif form == FORM_Q6K:
        want = ((i8, m * k), (i8, m * k // 16), none, (f32, m * k // 256), none)
    elif form == FORM_QS_NIB:
        want = ((u8, m * k // 2), (f32, m * k // 32), (f32, m * k // 32), none, none)
    elif form == FORM_DENSE:
        want = ((torch.bfloat16, m * k), none, none, none, none)
    else:
        want = (((u8, i8), m * k), (f32, m * k // gs), (f32, m * k // gs), none, none)
    return [(a, dt if isinstance(dt, tuple) else (dt,), L * n)
            for a, (dt, n) in zip(ops, want)]


def check_operands(name, want, dev):
    """Raise unless every present operand has its type, size, device,
    contiguity and 16-byte alignment."""
    for a, dts, n in want:
        if a is None:
            continue
        if a.dtype not in dts or a.numel() != n or a.device != dev:
            raise ValueError(f"{name}: a parameter is {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}, want {' or '.join(map(str, dts))} of {n} "
                             f"elements on {dev}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name}: every parameter must be contiguous and "
                             "16-byte aligned")


def prep_decode7(params: dict, info) -> dict | None:
    """The stacked decode blocks of a loaded model, or None when the
    model is not one the kernel takes: per-layer (list) blocks, a head
    size other than 64, C or the FFN width not a multiple of 256 (what
    :func:`layer_scan7` refuses on the card), a layer matrix of a form
    :func:`stack_matrix` does not take, or a LoRA rank that is not a
    multiple of 8."""
    blocks = params.get("blocks")
    if not isinstance(blocks, dict):
        return None
    C, hidden = info.num_emb, blocks["ffn"]["Wk"].shape[0]
    if (info.head_size != HEAD_SIZE or C != info.num_head * HEAD_SIZE or C % 256
            or hidden % 256):
        return None
    mats, forms = {}, {}
    for part, name in _MATRICES:
        slot = stack_matrix(blocks[part][name])
        if slot is None:
            return None
        forms[f"{part}.{name}"], mats[f"{part}.{name}"] = slot
    att, ffn = blocks["att"], blocks["ffn"]
    bf = torch.bfloat16
    pairs = (("w1", "w2"), ("a1", "a2"), ("g1", "g2"), ("v1", "v2"))
    if any(att[d].shape[-2] % 8 for d, _ in pairs):
        return None
    return {
        "L": info.num_layer, "C": info.num_emb, "H": info.num_head,
        "hs": info.head_size, "hidden": hidden,
        "lora_dims": tuple(int(att[d].shape[-2]) for d, _ in pairs),
        "ln1": (blocks["ln1"]["w"], blocks["ln1"]["b"]),
        "ln2": (blocks["ln2"]["w"], blocks["ln2"]["b"]),
        "x_stack": att["x_stack"],
        "vecs": {k: att[k] for k in ("w0", "a0", "v0", "k_k", "k_a")} | {"ffn_xk": ffn["x_k"]},
        "gn": (att["gn"]["w"], att["gn"]["b"]),
        "r_k": att["r_k"],
        "down": torch.cat([att[d].to(bf) for d, _ in pairs], dim=1).contiguous(),
        "up": torch.cat([att[u].to(bf) for _, u in pairs], dim=2).contiguous(),
        "mats": mats,  # per slot: its five operands (stack_matrix)
        "forms": forms,  # per slot: its descriptor
    }


def mega_layers(mega: dict, lo: int, hi: int) -> dict:
    """Layers ``lo:hi`` of the decode blocks (views, no copies)."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(cut(v) for v in t)
        return t[lo:hi] if isinstance(t, torch.Tensor) else t
    return {**cut(mega), "L": hi - lo}


def lora_plain(xin, down, up, act=None):
    """One inner-LoRA pair in plain PyTorch: bf16 operands, f32 products,
    the inner sum z = act(x·down) rounded to bf16 between them."""
    z = xin.to(torch.bfloat16).float() @ down.T
    if act is not None:
        z = act(z)
    return z.to(torch.bfloat16).float() @ up.T


def layer_scan7_plain(mega, state, x, mask, rescale, eps_ln, eps_gn, eps_l2,
                      v0_carry=None, ln_out=None, y_in=None, staged=None):
    """Plain version of :func:`layer_scan7`. ``ln_out = (xx1, xx2)``, each
    ``[L, B, C]`` or None, replaces the two LayerNorms' outputs of the
    lanes the mask keeps running (a check's: the kernel's own, which its
    new ``att_shift`` and ``ffn_shift`` states hold), so that a comparison
    with the kernel leaves out the order of the LayerNorms' sums; ``y_in``
    ``[L, B, C]`` likewise replaces the attention's output (Wo's bf16
    input: a one-layer launch's ``staged["y"]``). ``staged``, a dict,
    receives the last layer's attention output ``y`` (f32 ``[B, C]``, as
    Wo takes it), as the kernel's does."""
    L, H = mega["L"], mega["H"]
    v_first, first = v0_carry if v0_carry is not None else (None, 0)
    offs = [0]
    for d in mega["lora_dims"]:
        offs.append(offs[-1] + d)
    vec = mega["vecs"]
    keep = mask.bool()[:, None]
    x = x.float()
    bsz, C = x.shape
    news = {k: [] for k in ("att_shift", "wkv", "ffn_shift")}

    def heads(t):
        return t.reshape(bsz, H, -1)

    for i in range(L):
        def mat(name, xin, i=i):
            return slot_gemv_plain(mega["forms"][name], mega["mats"][name], i, xin)

        down, up = mega["down"][i].float(), mega["up"][i].float()

        def lora(xin, j, act=None, down=down, up=up):
            return lora_plain(xin, down[offs[j]:offs[j + 1]], up[:, offs[j]:offs[j + 1]], act)

        xx = B_.layer_norm(x, mega["ln1"][0][i], mega["ln1"][1][i], eps_ln)
        if ln_out is not None and ln_out[0] is not None:
            xx = torch.where(keep, ln_out[0][i], xx)
        sh = state["att_shift"][i]
        mixed = xx[:, None] + mega["x_stack"][i][None] * (sh - xx)[:, None]
        rx, wx, kx, vx, ax, gx = mixed.unbind(1)
        r, k, v = mat("att.Wr", rx), mat("att.Wk", kx), mat("att.Wv", vx)
        w_in = vec["w0"][i] + lora(wx, 0, torch.tanh)
        a_in = vec["a0"][i] + lora(ax, 1)
        g = lora(gx, 2, torch.sigmoid)
        if first + i == 0:
            v_first = v
        else:
            v = v + torch.sigmoid(vec["v0"][i] + lora(vx, 3)) * (v_first - v)
        y, wkv = att_core7_plain(
            state["wkv"][i], heads(r), heads(w_in), heads(k), heads(v), heads(a_in),
            heads(g), vec["k_k"][i].reshape(H, -1), vec["k_a"][i].reshape(H, -1),
            mega["gn"][0][i].reshape(H, -1), mega["gn"][1][i].reshape(H, -1),
            mega["r_k"][i], mask, eps_gn, eps_l2)
        y = y.reshape(bsz, C)
        if y_in is not None:
            y = torch.where(keep, y_in[i].float(), y)
        if staged is not None:
            staged["y"] = y
        x = x + mat("att.Wo", y)
        xx2 = B_.layer_norm(x, mega["ln2"][0][i], mega["ln2"][1][i], eps_ln)
        if ln_out is not None and ln_out[1] is not None:
            xx2 = torch.where(keep, ln_out[1][i], xx2)
        fsh = state["ffn_shift"][i]
        kx2 = xx2 + vec["ffn_xk"][i] * (fsh - xx2)
        x = x + mat("ffn.Wv", B_.squared_relu(mat("ffn.Wk", kx2)))
        if rescale and (first + i + 1) % rescale == 0:
            x = x * 0.5
        news["att_shift"].append(torch.where(keep, xx, sh))
        news["wkv"].append(wkv)
        news["ffn_shift"].append(torch.where(keep, xx2, fsh))
    new = {k: torch.stack(v) for k, v in news.items()}
    return (x, new) if v0_carry is None else (x, new, v_first)


@functools.cache
def _fn():
    fn = build.load("layer7").layer_scan7
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def _operands(mega, dev):
    """The kernel's parameter operands in its order (None for an array a
    matrix form lacks), each checked against the shape and type the
    kernel reads."""
    L, C, hidden = mega["L"], mega["C"], mega["hidden"]
    D = sum(mega["lora_dims"])
    vec = mega["vecs"]
    f32, bf = (torch.float32,), (torch.bfloat16,)
    want = [(a, f32, L * C) for a in (*mega["ln1"], *mega["ln2"])]
    want.append((mega["x_stack"], f32, L * 6 * C))
    want += [(vec[k], f32, L * C) for k in ("w0", "a0", "v0", "k_k", "k_a", "ffn_xk")]
    want += [(a, f32, L * C) for a in (*mega["gn"], mega["r_k"])]
    want += [(mega["down"], bf, L * D * C), (mega["up"], bf, L * C * D)]
    for part, name in _MATRICES:
        m, k = {"ffn.Wk": (hidden, C), "ffn.Wv": (C, hidden)}.get(f"{part}.{name}", (C, C))
        key = f"{part}.{name}"
        want += slot_operands(mega["forms"][key], mega["mats"][key], L, m, k)
    check_operands("layer_scan7", want, dev)
    return [a for a, _, _ in want]


def layer_scan7(mega, state, x, mask, rescale, eps_ln, eps_gn, eps_l2, v0_carry=None,
                phase_ns=None, staged=None):
    """One decode token through every layer.

    ``state``: layer-stacked ``att_shift`` / ``ffn_shift`` ``[L, B, C]``
    and ``wkv`` ``[L, B, H, K, V]``; ``x`` ``[B, C]`` the ln0-normalized
    input; ``mask`` ``[B]`` (0 freezes a lane's state); ``rescale``
    halves the residual after every ``rescale``-th layer (None: never).
    Returns ``(x [B, C], new_state)`` in f32; the input state is left as
    it was. ``v0_carry = (v_first [B, C] or None, first_layer)`` runs
    ``mega`` as the slice of the stack from global layer ``first_layer``
    (``v_first``, layer 0's v, is needed when that is not 0) and returns
    ``(x, new_state, v_first)``. ``phase_ns``, an int64 tensor of
    ``1 + 5·L`` on the card, receives the device clock (ns) at the start
    and after each of every layer's five phases (:data:`PHASES`) (the kernel only; the
    plain version leaves it untouched). ``staged``, a dict, receives the
    last layer's attention output ``y`` (bf16 ``[B, C]``, Wo's input; the
    kernel only)."""
    if not x.is_cuda:
        return layer_scan7_plain(mega, state, x, mask, rescale, eps_ln, eps_gn, eps_l2,
                                 v0_carry)
    L, C, H, hs, hidden = (mega[k] for k in ("L", "C", "H", "hs", "hidden"))
    bsz = x.shape[0]
    if hs != HEAD_SIZE or C % 256 or hidden % 256 or not 1 <= bsz <= MAX_SCAN_BATCH:
        raise ValueError(f"layer_scan7: the kernel takes head size {HEAD_SIZE}, C and "
                         f"hidden multiples of 256 and 1..{MAX_SCAN_BATCH} lanes; got "
                         f"head size {hs}, C={C}, hidden={hidden}, B={bsz}")
    dev = x.device
    ops = _operands(mega, dev)
    v_first, first = v0_carry if v0_carry is not None else (None, 0)
    if first > 0 and (v_first is None or tuple(v_first.shape) != (bsz, C)
                      or v_first.device != dev):
        raise ValueError(f"layer_scan7: a slice from layer {first} needs layer 0's v "
                         f"[{bsz}, {C}] on {dev}")
    want = {"att_shift": (L, bsz, C), "ffn_shift": (L, bsz, C), "wkv": (L, bsz, H, hs, hs)}
    st = {}
    for key, shape in want.items():
        a = state[key]
        if tuple(a.shape) != shape or a.device != dev:
            raise ValueError(f"layer_scan7: state {key} must be {shape} on {dev}, got "
                             f"{tuple(a.shape)} on {a.device}")
        st[key] = a.float().contiguous()
    out = {key: torch.empty_like(a) for key, a in st.items()}
    x_io = x.float().contiguous().clone()
    m = mask.float().contiguous()
    D = mega["down"].shape[1]
    bf, f32 = torch.bfloat16, torch.float32
    scratch = [torch.empty(3, bsz, C, dtype=f32, device=dev),
               torch.empty(bsz, D, dtype=bf, device=dev),
               (torch.empty(bsz, C, dtype=f32, device=dev) if v_first is None
                else v_first.float().contiguous().clone()),
               torch.empty(bsz, C, dtype=bf, device=dev),
               torch.empty(bsz, hidden, dtype=bf, device=dev)]
    # split-K scratch, at least what the kernel's plan needs (it checks):
    # a phase's rows (phase 1: Wr, Wk, Wv and up to four LoRA downs, each
    # rounded up to 16-row tiles) in K-slices of 256 or more
    rows = max(3 * C + D + 4 * 16, hidden)
    part = torch.empty(bsz * C * rows // 256, dtype=f32, device=dev)
    ptrs = [0 if a is None else a.data_ptr() for a in ops] + [
        st["att_shift"].data_ptr(), st["ffn_shift"].data_ptr(), st["wkv"].data_ptr(),
        out["att_shift"].data_ptr(), out["ffn_shift"].data_ptr(), out["wkv"].data_ptr(),
        m.data_ptr(), x_io.data_ptr(), *(a.data_ptr() for a in scratch)]
    if phase_ns is not None:
        n_ns = 1 + len(PHASES) * L
        if phase_ns.dtype != torch.int64 or phase_ns.numel() != n_ns or phase_ns.device != dev:
            raise ValueError(f"layer_scan7: phase_ns must be int64 [{n_ns}] on {dev}")
    with torch.cuda.device(dev):
        cnt = _counters(dev, -(-rows // 16))
        ptrs += [0 if phase_ns is None else phase_ns.data_ptr(), part.data_ptr(),
                 cnt.data_ptr()]
        ints = [L, bsz, C, H, hidden, D, *mega["lora_dims"], rescale or 0, first,
                *(mega["forms"][f"{p}.{name}"] for p, name in _MATRICES), part.numel(),
                cnt.numel()]
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                    (ctypes.c_float * 3)(eps_ln, eps_gn, eps_l2), stream)
    layer_scan7.launches += 1
    layer_scan7.shapes[(L, bsz, C)] += 1
    if err:
        raise RuntimeError(f"layer_scan7 launch failed: CUDA error {err}")
    if staged is not None:  # y is stored in the staged order
        staged["y"] = unstage(scratch[3])
    return (x_io, out) if v0_carry is None else (x_io, out, scratch[2])


layer_scan7.launches = 0
layer_scan7.shapes = collections.Counter()  # launches by (L, B, C)
