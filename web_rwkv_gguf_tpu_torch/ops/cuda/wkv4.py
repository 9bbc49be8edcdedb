"""The RWKV-4 WKV scan (``csrc/wkv4_scan.cu``) and its plain version.

``wkv4_scan`` runs the V4 recurrence over a chunk of tokens, each
channel's tokens split over up to 16 warps whose segments meet through
the update's associative form (``csrc/wkv4_scan.cu``). Every V4 chunk
takes it, T = 1 and T ≥ 128 included.

On a CUDA tensor it launches the kernel or raises; only a tensor on the
CPU takes the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .. import wkv as W
from . import build
from .wkv7 import mask_bytes


def wkv4_scan_plain(state, k, v, r, u, w, mask):
    """Plain version of :func:`wkv4_scan` (``ops/wkv.wkv4``)."""
    return W.wkv4(state, k, v, r, u, w, mask.bool())


@functools.cache
def _fn():
    fn = build.load("wkv4_scan").wkv4_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wkv4_scan(state, k, v, r, u, w, mask):
    """The V4 recurrence over a chunk, with the layouts of the JAX
    package's ``wkv4_pallas``: ``state`` ``[B, C, 3]`` (aa, bb, pp);
    ``k, v, r`` ``[B, T, C]`` (r before the sigmoid); ``u`` (time_first)
    and ``w`` (-exp(decay)) ``[C]``; ``mask`` ``[B, T]`` bool. Returns
    ``(y [B, T, C], new_state [B, C, 3])``, f32, y = σ(r)·wkv. Padded
    tokens leave the state bit for bit; y there is unspecified. The input
    state is not modified."""
    if not state.is_cuda:
        return wkv4_scan_plain(state, k, v, r, u, w, mask)
    if state.dim() != 3 or state.shape[2] != 3:
        raise ValueError(f"wkv4_scan: state must be [B, C, 3], got {tuple(state.shape)}")
    bsz, c, _ = state.shape
    t = k.shape[1]
    given = {"k": k, "v": v, "r": r, "u": u, "w": w, "mask": mask}
    ops = {}
    for key, x in given.items():
        want = {"mask": (bsz, t), "u": (c,), "w": (c,)}.get(key, (bsz, t, c))
        if tuple(x.shape) != want:
            raise ValueError(f"wkv4_scan: {key} must be {want}, got {tuple(x.shape)}")
        if x.device != state.device:
            raise ValueError(f"wkv4_scan: {key} on {x.device}, state on {state.device}")
        ops[key] = mask_bytes(x) if key == "mask" else x.float().contiguous()
    st = state.float().contiguous()
    y = torch.empty(bsz, t, c, dtype=torch.float32, device=state.device)
    s1 = torch.empty_like(st)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(st.data_ptr(), *(ops[key].data_ptr() for key in given),
                    y.data_ptr(), s1.data_ptr(), bsz, t, c, stream)
    wkv4_scan.launches += 1
    wkv4_scan.shapes[(bsz, t, c)] += 1
    if err:
        raise RuntimeError(f"wkv4_scan launch failed: CUDA error {err}")
    return y, s1


wkv4_scan.launches = 0
wkv4_scan.shapes = collections.Counter()  # launches by (B, T, C)
