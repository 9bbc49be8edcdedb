"""The RWKV-6 WKV scan (``csrc/wkv6_scan.cu``) and its plain version.

``wkv6_scan`` runs the V6 recurrence over a chunk of tokens with the
state kept on chip: per (lane, head) ``y = Sᵀr + (Σ_k r·u·k) v``, then
``S ← diag(w)S + k vᵀ``. Prefill chunks of 2 ≤ T < 128 take it, as the
JAX package's ``wkv6_pallas``; the port's per-layer decode path takes it
at T = 1 too, so that no plain version sits on a card path.

V5 calls it with its static decay ``expand``ed over lanes and tokens; the
kernel reads that view in place (:func:`decay_operand`).

On a CUDA tensor it launches the kernel (head size 64) or raises; only a
tensor on the CPU takes the plain version, which takes any head size.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .. import wkv as W
from . import build
from .wkv7 import mask_bytes, scan_operand

HEAD_SIZE = 64  # the head size the kernel takes


def wkv6_scan_plain(state, r, k, v, u, w, mask):
    """Plain version of :func:`wkv6_scan`: pre-mask as the kernel does,
    then the reference recurrence token by token (``ops/wkv.wkv6``)."""
    m = mask.bool()
    return W.wkv6(state, r, k.float() * m[..., None, None], v, u,
                  torch.where(m[..., None, None], w.float(), 1.0), m)


@functools.cache
def _fn():
    fn = build.load("wkv6_scan").wkv6_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decay_operand(w):
    """``(w, static)``: ``w`` [B, T, H, K] as the kernel reads it. One f32
    [H, K] decay ``expand``ed over lanes and tokens (V5's static decay) is
    read in place (``static``, no copy); anything else as a contiguous f32
    copy."""
    lane, tok, head, key = w.stride()
    bsz, t = w.shape[:2]
    if (w.dtype == torch.float32 and (lane == 0 or bsz == 1) and (tok == 0 or t == 1)
            and (head, key) == (w.shape[3], 1)):
        return w, True  # a dimension of one is read at index 0 whatever its stride
    return scan_operand(w), False


def wkv6_scan(state, r, k, v, u, w, mask):
    """The V6 recurrence over a chunk, with the layouts of the JAX
    package's ``wkv6_pallas``: ``state`` ``[B, H, K, V]``; ``r, k, w``
    ``[B, T, H, K]`` (w activated); ``v`` ``[B, T, H, V]``; ``u``
    ``[H, K]``; ``mask`` ``[B, T]`` bool. Returns ``(y [B, T, H, V],
    new_state)``, f32. Padded tokens leave the state exactly as it was
    (w ← 1, k ← 0 there); y at a padded token is read from that unchanged
    state. The input state is not modified."""
    if not state.is_cuda:
        return wkv6_scan_plain(state, r, k, v, u, w, mask)
    bsz, h, kdim, vdim = state.shape
    if kdim != HEAD_SIZE or vdim != HEAD_SIZE:
        raise ValueError(f"wkv6_scan: the kernel takes head size {HEAD_SIZE}, "
                         f"got {kdim}x{vdim}")
    t = r.shape[1]
    given = {"r": r, "k": k, "v": v, "u": u, "w": w, "mask": mask}
    ops = {}
    for key, x in given.items():
        want = {"mask": (bsz, t), "u": (h, kdim)}.get(key, (bsz, t, h, kdim))
        if tuple(x.shape) != want:
            raise ValueError(f"wkv6_scan: {key} must be {want}, got {tuple(x.shape)}")
        if x.device != state.device:
            raise ValueError(f"wkv6_scan: {key} on {x.device}, state on {state.device}")
        if key == "mask":
            ops[key] = mask_bytes(x)
        elif key == "w":
            ops[key], static_w = decay_operand(x)
        else:
            ops[key] = scan_operand(x)
    st = state.float().contiguous()
    y = torch.empty(bsz, t, h, vdim, dtype=torch.float32, device=state.device)
    s1 = torch.empty_like(st)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(st.data_ptr(), *(ops[key].data_ptr() for key in given),
                    y.data_ptr(), s1.data_ptr(), bsz, t, h, kdim, static_w, stream)
    wkv6_scan.launches += 1
    wkv6_scan.shapes[(bsz, t, h, kdim)] += 1
    if err:
        raise RuntimeError(f"wkv6_scan launch failed: CUDA error {err}")
    return y, s1


wkv6_scan.launches = 0
wkv6_scan.shapes = collections.Counter()  # launches by (B, T, H, head size)
