"""Sequence-parallel prefill: a long chunk's tokens cut over the ranks of
one mesh axis.

The port of the JAX package's ``parallel/sequence.py``. Rank i of the
axis (n ranks) takes tokens ``i·T/n : (i+1)·T/n`` of every lane. The WKV
recurrence acts on the state as an affine map per head over a block of
tokens, ``S_out = M·S_in + O``, so each rank computes its block's map
from its own tokens, the ranks gather the small maps (``sharding.
all_gather``), and each composes the maps of the ranks before it onto
the carried state: the true state at its block's start. A second pass
over the block from that state gives its outputs, through the port's
forward router (``models.forward._wkv7`` …), so that a block under 128
tokens runs the WKV scan kernel. The maps, as the JAX package computes
them outside any kernel:

- RWKV-7: ``(M, O)`` from the sub-chunk form of ``ops/wkv_chunked``
  (:func:`_wkv7_transition`), in f32 matmuls;
- RWKV-6, -5: the transition is diagonal, ``D = Π w`` over the block,
  and ``O`` is the block's final state from a zero state;
- RWKV-4: the block's ``(a, b, p)`` from a zero state, composed with the
  carried one by the running-max blend, its decay ``T_block · w``.

The token shift needs the last LayerNorm'd row of the rank to the left:
one ``all_gather`` of ``[B, C]`` over the axis; rank 0 takes the carried
shift state. The layers are the port's own (``models.forward._layer_v7``
… ``_layer_v4``), given a :class:`SeqBlock` for their two seams (the
previous row, the WKV); the JAX package keeps mirrors of them instead.
Every lane must be full length, T must divide by ``n · 16``; the weights
are whole on every rank, and the new state, the last rank's, is
broadcast to every rank of the axis.
"""

from __future__ import annotations

import torch

from ..errors import EngineError, UnsupportedFeature
from ..models.forward import _LAYERS, Block, _layer_v7, embed_tokens
from ..models.info import ModelInfo, ModelVersion
from ..models.loader import layer_params
from ..ops.wkv import F32_MIN
from ..ops.wkv_chunked import CHUNK, _tri_solve_unit_lower
from .sharding import Mesh, all_gather, broadcast

VERSIONS = (ModelVersion.V7, ModelVersion.V6, ModelVersion.V5, ModelVersion.V4)


def _wkv7_transition(r, w, k, v, a, b, *, chunk: int = CHUNK):
    """The RWKV-7 block's per-head affine map: ``(M [B, H, K, K], O [B, H,
    K, V])`` with ``S_after = M·S_before + O`` (the JAX package's
    ``_wkv7_transition``). Composed from sub-chunk maps ``M_c =
    diag(P_L)(I + B̂ᵀT⁻¹Â)``, ``O_c = diag(P_L)(B̂ᵀT⁻¹·strict_tril(ÂK̂ᵀ)V +
    K̂ᵀV)`` (the notation of ``ops/wkv_chunked``); ``r`` is not read (the
    signature is the JAX package's). T must divide by ``chunk``."""
    f32 = torch.float32
    Bb, T, H, K = w.shape
    V = v.shape[-1]
    if T % chunk:
        raise EngineError(f"a block of {T} tokens does not divide in sub-chunks of {chunk}")
    n = T // chunk

    def to_chunks(x):  # [n, B, H, chunk, ·]
        return x.float().reshape(Bb, n, chunk, H, -1).permute(1, 0, 3, 2, 4)

    wc, kc, vc, ac, bc = map(to_chunks, (w, k, v, a, b))
    strict = torch.tril(torch.ones(chunk, chunk, dtype=f32, device=w.device), -1)
    eye = torch.eye(K, dtype=f32, device=w.device)
    M = eye.expand(Bb, H, K, K).clone()
    O = torch.zeros(Bb, H, K, V, dtype=f32, device=w.device)
    for c in range(n):
        ww, kk, vv, aa, bb = wc[c], kc[c], vc[c], ac[c], bc[c]
        P = torch.cumprod(ww, dim=2)
        inv_P = 1.0 / P
        a_h, b_h, k_h = aa * (P / ww), bb * inv_P, kk * inv_P
        ab = (a_h @ b_h.transpose(-1, -2)) * strict
        ak = (a_h @ k_h.transpose(-1, -2)) * strict
        # U = T⁻¹(Â S_in + L_ak V): its state part and its constant part
        t_a = _tri_solve_unit_lower(ab, a_h)
        t_c = _tri_solve_unit_lower(ab, ak @ vv)
        PL = P[:, :, -1, :, None]
        M_c = PL * (eye + b_h.transpose(-1, -2) @ t_a)
        O_c = PL * (b_h.transpose(-1, -2) @ t_c + k_h.transpose(-1, -2) @ vv)
        M, O = M_c @ M, M_c @ O + O_c
    return M, O


def _compose4(S, loc, decay):
    """RWKV-4's carried ``(a, b, p)`` ``[B, C, 3]`` after a block whose
    state from zero is ``loc`` and whose decay of the old state is
    ``decay`` (log, per channel): the running-max blend."""
    p0d = S[..., 2] + decay
    q = torch.maximum(p0d, loc[..., 2])
    e1, e2 = torch.exp(p0d - q), torch.exp(loc[..., 2] - q)
    return torch.stack([e1 * S[..., 0] + e2 * loc[..., 0], e1 * S[..., 1] + e2 * loc[..., 1],
                        q], dim=-1)


class SeqBlock(Block):
    """This rank's block of a sequence cut over ``axis`` of ``mesh``: the
    row before its first token comes from the rank to the left, and its
    WKV starts from the state the blocks before it leave."""

    def __init__(self, mesh: Mesh, axis: str = "model"):
        self.mesh, self.axis = mesh, axis
        self.index = mesh.coord(axis)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked on a new leading axis, in axis order."""
        return all_gather(self.mesh, self.axis, t[None], dim=0)

    def previous(self, xx, shift):
        rows = self._gather(xx[:, -1])
        return shift if self.index == 0 else rows[self.index - 1]

    def wkv(self, version, state, *args):
        i = self.index
        if version == ModelVersion.V7:
            K = state.shape[-2]
            maps = self._gather(torch.cat(_wkv7_transition(*args[:6]), dim=-1))
            S = state.float()
            for Mi in maps[:i]:
                S = Mi[..., :K] @ S + Mi[..., K:]
        elif version == ModelVersion.V4:
            k, w = args[0], args[4]
            zero = torch.stack([torch.zeros_like(state[..., 0]), torch.zeros_like(state[..., 0]),
                                torch.full_like(state[..., 0], F32_MIN)], dim=-1)
            locs = self._gather(super().wkv(version, zero, *args)[1])
            decay = k.shape[1] * w.float()
            S = state.float()
            for loc in locs[:i]:
                S = _compose4(S, loc, decay)
        else:  # RWKV-6 and -5 (whose w is the static [H, K] decay)
            r, w = args[0], args[4]
            D = torch.prod(w.float().expand(r.shape), dim=1)[..., None]
            _, O = super().wkv(version, torch.zeros_like(state), *args)
            maps = self._gather(torch.cat([D, O], dim=-1))
            S = state.float()
            for Mi in maps[:i]:
                S = Mi[..., :1] * S + Mi[..., 1:]
        return super().wkv(version, S, *args)


def make_seq_parallel_prefill(info: ModelInfo, mesh: Mesh, *, axis: str = "model",
                              rescale: int | None = None):
    """The sequence-parallel prefill of any model version (the JAX
    package's ``make_seq_parallel_prefill``).

    ``fn(params, state, tokens [B, T]) -> (x [B, T/n, C], new_state)``:
    every rank is given the whole model's ``params``, the same ``state``
    of the B lanes (``[L, B, ...]``, whole) and the same tokens, and
    returns x of its own tokens (rank i's ``i·T/n : (i+1)·T/n``) and the
    new state of the whole chunk, the same on every rank of the axis.
    Every lane is taken as full length; T must divide by ``n · 16``.
    ``rescale`` halves the residual every N layers, as ``forward_chunk``
    does."""
    if info.version not in VERSIONS:
        raise UnsupportedFeature("sequence-parallel prefill supports V4/V5/V6/V7")
    block = SeqBlock(mesh, axis)
    n = mesh.shape[axis]
    group, ranks = mesh.group(axis)
    L = info.num_layer
    do_rescale = rescale is not None and rescale < L

    def fn(params, state, tokens):
        tokens = torch.as_tensor(tokens, device=mesh.device)
        Bb, T = tokens.shape
        if T % (n * CHUNK):
            raise EngineError(f"sequence-parallel prefill: T={T} must divide by "
                              f"{n} ranks x {CHUNK}")
        t_loc = T // n
        tok = tokens[:, block.index * t_loc:(block.index + 1) * t_loc]
        x, v0 = embed_tokens(params, tok), None
        lens = torch.full((Bb,), t_loc, dtype=torch.long, device=mesh.device)
        mask = torch.ones(Bb, t_loc, dtype=torch.bool, device=mesh.device)
        news = []
        for i, blk in enumerate(layer_params(params, L)):
            lst = {k: a[i] for k, a in state.items()}
            if info.version == ModelVersion.V7:
                x, v0, new = _layer_v7(info, blk, lst, x, v0, i, mask, lens, block=block)
            else:
                x, new = _LAYERS[info.version](info, blk, lst, x, mask, lens, block=block)
            if do_rescale and (i + 1) % rescale == 0:
                x = x * 0.5
            news.append(new)
        new_state = {k: torch.stack([nw[k] for nw in news]) for k in state}
        if group is not None:  # the last rank's state, on every rank
            new_state = {k: broadcast(a, ranks[-1], group=group, device=mesh.device)
                         for k, a in new_state.items()}
        return x, new_state

    return fn
