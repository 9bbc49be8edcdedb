"""RWKV-7 attention kernels and their plain versions.

- ``att_core7_step``: the fused attention core of one decode token. Per
  (batch lane, head): the decay activation, the kk l2-norm, control-k,
  the delta-rule state update, group norm over the values, the r_k
  bonus and the gate (``csrc/att_core7.cu``).
- ``wkv7_scan``: the delta rule over a chunk of 2 ≤ T < 128 prefill
  tokens, with the state kept on chip (``csrc/wkv7_scan.cu``).

On a CUDA tensor each launches its hand-written kernel (head size 64) or
raises; only a tensor on the CPU takes the plain version, which takes any
head size.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .. import basic as B_
from .. import wkv as W
from . import build

HEAD_SIZE = 64  # the head size the kernel takes


def att_core7_plain(state, r, w_raw, k_raw, v, a_raw, g, k_k, k_a, gn_w,
                    gn_b, r_k, mask, eps, l2_eps):
    """Plain version of :func:`att_core7_step`."""
    b, h, vdim = v.shape
    w = W.wkv7_act_w(w_raw)
    a = torch.sigmoid(a_raw.float())
    kk = B_.l2_normalize(k_raw * k_k[None], l2_eps)
    k = k_raw * (1.0 + (a - 1.0) * k_a[None])
    y0, s1 = W.wkv7_step(
        state.float(), r[:, None], w[:, None], k[:, None], v[:, None],
        (-kk)[:, None], (kk * a)[:, None], mask.bool()[:, None],
    )
    y = B_.group_norm(y0.reshape(b, h * vdim), gn_w.reshape(-1),
                      gn_b.reshape(-1), h, eps)
    y = y + W.wkv7_bonus(r, k, v, r_k).reshape(b, h * vdim)
    return (y * g.reshape(b, h * vdim)).reshape(b, h, vdim), s1


@functools.cache
def _fn():
    fn = build.load("att_core7").att_core7
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def att_core7_step(state, r, w_raw, k_raw, v, a_raw, g, k_k, k_a, gn_w, gn_b,
                   r_k, mask, eps: float, l2_eps: float):
    """Fused T=1 attention core.

    ``state`` f32 ``[B, H, K, V]``; ``r, w_raw, k_raw, a_raw`` ``[B, H, K]``
    (w_raw and a_raw before their activations, k_raw before control-k);
    ``v, g`` ``[B, H, V]`` (g is the final gate); ``k_k, k_a, r_k``
    ``[H, K]``; ``gn_w, gn_b`` ``[H, V]``; ``mask`` ``[B]`` bool.
    Returns ``(y [B, H, V] f32, new_state)``: masked lanes keep their
    state, and their y is unspecified. The input state is not modified.
    """
    if not state.is_cuda:
        return att_core7_plain(state, r, w_raw, k_raw, v, a_raw, g, k_k, k_a,
                               gn_w, gn_b, r_k, mask, eps, l2_eps)
    b, h, kdim, vdim = state.shape
    if kdim != HEAD_SIZE or vdim != HEAD_SIZE:
        raise ValueError(f"att_core7: the kernel takes head size {HEAD_SIZE}, "
                         f"got {kdim}x{vdim}")
    shapes = {"r": (b, h, kdim), "w_raw": (b, h, kdim), "k_raw": (b, h, kdim),
              "v": (b, h, vdim), "a_raw": (b, h, kdim), "g": (b, h, vdim),
              "k_k": (h, kdim), "k_a": (h, kdim), "gn_w": (h, vdim),
              "gn_b": (h, vdim), "r_k": (h, kdim), "mask": (b,)}
    given = {"r": r, "w_raw": w_raw, "k_raw": k_raw, "v": v, "a_raw": a_raw,
             "g": g, "k_k": k_k, "k_a": k_a, "gn_w": gn_w, "gn_b": gn_b,
             "r_k": r_k, "mask": mask}
    ops = {}
    for key, a in given.items():
        if tuple(a.shape) != shapes[key]:
            raise ValueError(f"att_core7: {key} must be {shapes[key]}, got "
                             f"{tuple(a.shape)}")
        if a.device != state.device:
            raise ValueError(f"att_core7: {key} on {a.device}, state on "
                             f"{state.device}")
        # the kernel reads 16 bytes at a time, and the mask as bytes
        ops[key] = mask_bytes(a) if key == "mask" else scan_operand(a)
    st = scan_operand(state)
    y = torch.empty(b, h, vdim, dtype=torch.float32, device=state.device)
    s1 = torch.empty_like(st)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(st.data_ptr(), *(ops[key].data_ptr() for key in shapes),
                    y.data_ptr(), s1.data_ptr(), b, h, kdim, eps, l2_eps,
                    stream)
    att_core7_step.launches += 1
    att_core7_step.shapes[(b, h, kdim)] += 1
    if err:
        raise RuntimeError(f"att_core7 launch failed: CUDA error {err}")
    return y, s1


att_core7_step.launches = 0
att_core7_step.shapes = collections.Counter()  # launches by (B, H, head size)


def wkv7_scan_plain(state, r, w, k, v, a, b, mask):
    """Plain version of :func:`wkv7_scan`: pre-mask, then the delta rule
    token by token."""
    m = mask.bool()[..., None, None]
    w = torch.where(m, w.float(), 1.0)
    k = k.float() * m
    b = b.float() * m
    r, v, a = r.float(), v.float(), a.float()
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        sa = torch.einsum("bhk,bhkv->bhv", a[:, t], S)
        S = (w[:, t, ..., None] * S + k[:, t, ..., None] * v[:, t, :, None, :]
             + b[:, t, ..., None] * sa[:, :, None, :])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S))
    return torch.stack(ys, dim=1), S


def scan_operand(x):
    """``x`` as the scan kernels and the attention core read it: f32,
    contiguous, its first element 16-byte aligned (the base address a TMA
    copy or a 16-byte load takes)."""
    x = x.float().contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def mask_bytes(mask):
    """``mask`` as the kernels read it: one byte an element, 0 where
    masked. A contiguous bool tensor is read in place, with no launch."""
    m = mask if mask.dtype == torch.bool else mask != 0
    return m.contiguous().view(torch.uint8)


@functools.cache
def _scan_fn():
    fn = build.load("wkv7_scan").wkv7_scan
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wkv7_scan(state, r, w, k, v, a, b, mask):
    """The V7 delta rule over a chunk, with the layouts of the JAX
    package's ``wkv7_pallas``: ``state`` ``[B, H, K, V]``; ``r, w, k, a,
    b`` ``[B, T, H, K]`` (w already activated); ``v`` ``[B, T, H, V]``;
    ``mask`` ``[B, T]`` bool. Returns ``(y [B, T, H, V], new_state)``,
    f32. Padded tokens leave the state as it was (w ← 1, k ← 0, b ← 0
    there); y at a padded token is read from that unchanged state. The
    input state is not modified."""
    if not state.is_cuda:
        return wkv7_scan_plain(state, r, w, k, v, a, b, mask)
    bsz, h, kdim, vdim = state.shape
    if kdim != HEAD_SIZE or vdim != HEAD_SIZE:
        raise ValueError(f"wkv7_scan: the kernel takes head size {HEAD_SIZE}, "
                         f"got {kdim}x{vdim}")
    t = r.shape[1]
    given = {"r": r, "w": w, "k": k, "v": v, "a": a, "b": b, "mask": mask}
    ops = {}
    for key, x in given.items():
        want = (bsz, t) if key == "mask" else (bsz, t, h, kdim)
        if tuple(x.shape) != want:
            raise ValueError(f"wkv7_scan: {key} must be {want}, got "
                             f"{tuple(x.shape)}")
        if x.device != state.device:
            raise ValueError(f"wkv7_scan: {key} on {x.device}, state on "
                             f"{state.device}")
        ops[key] = mask_bytes(x) if key == "mask" else scan_operand(x)
    st = state.float().contiguous()
    y = torch.empty(bsz, t, h, vdim, dtype=torch.float32, device=state.device)
    s1 = torch.empty_like(st)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _scan_fn()(st.data_ptr(), *(ops[key].data_ptr() for key in given),
                         y.data_ptr(), s1.data_ptr(), bsz, t, h, kdim, stream)
    wkv7_scan.launches += 1
    wkv7_scan.shapes[(bsz, t, h, kdim)] += 1
    if err:
        raise RuntimeError(f"wkv7_scan launch failed: CUDA error {err}")
    return y, s1


wkv7_scan.launches = 0
wkv7_scan.shapes = collections.Counter()  # launches by (B, T, H, head size)
