"""RWKV-7 to RWKV-4 WKV recurrences in plain PyTorch — the ground truth
of the port's WKV kernels (the chunk forms are
``ops/cuda/wkv7.wkv7_scan_plain``, ``ops/cuda/wkv6.wkv6_scan_plain``,
``ops/cuda/wkv4.wkv4_scan_plain`` and ``ops/wkv_chunked``).

Layout ``[B, T, ...]`` with a validity mask: masked (padding) steps
leave the recurrent state untouched. From V5 on the state is one matrix
S[K, V] per head (K indexes key channels, V value channels); V4 keeps
three numbers per channel.

    V7: sa = Sᵀa;  S ← diag(w)S + k vᵀ + b saᵀ;  y = Sᵀr
        with a = -kk, b = kk ∘ a_ctrl, w = exp(-exp(-0.5)·sigmoid(w_in))
    V6: y = Sᵀr + (Σ_k r·u·k) v;  S ← diag(w)S + k vᵀ
        with w = exp(-exp(w_raw)) per token and u (time_first) per head
    V5: V6 with one static w per channel (activated at load)
    V4: per channel (aa, bb, pp), the running-max form of
        y = σ(r)·(e^{u+k}·v + Σ e^{…}·v) / (e^{u+k} + Σ e^{…}), pp
        starting at F32_MIN, w = -exp(raw) per channel
"""

from __future__ import annotations

import torch

F32_MIN = torch.finfo(torch.float32).min  # V4's initial running maximum pp


def wkv7_step(state, r, w, k, v, a, b, mask):
    """One token of the delta rule. ``state`` [B, H, K, V]; ``r, w, k,
    a, b`` [B, T=1, H, K]; ``v`` [B, 1, H, V]; ``mask`` [B, 1] bool.
    Returns ``(y [B, 1, H, V], new_state)``."""
    rr, ww = r[:, 0].float(), w[:, 0].float()
    kk, vv = k[:, 0].float(), v[:, 0].float()
    aa, bb = a[:, 0].float(), b[:, 0].float()
    sa = torch.einsum("bhk,bhkv->bhv", aa, state)
    s_n = (
        ww[..., :, None] * state
        + kk[..., :, None] * vv[..., None, :]
        + bb[..., :, None] * sa[..., None, :]
    )
    y = torch.einsum("bhk,bhkv->bhv", rr, s_n)
    s = torch.where(mask[:, 0][:, None, None, None], s_n, state)
    return y[:, None], s


def wkv7_act_w(w_in: torch.Tensor) -> torch.Tensor:
    """V7 decay activation: exp(-exp(-0.5)·sigmoid(x)); 0.606531 = exp(-0.5)."""
    return torch.exp(-0.606531 * torch.sigmoid(w_in.float()))


def wkv7_bonus(r, k, v, r_k):
    """V7 ``time_first`` bonus: y += (Σ_k r·k·r_k) · v per head.
    ``r, k`` [B, T, H, K], ``v`` [B, T, H, V], ``r_k`` [H, K]."""
    s = (r.float() * k.float() * r_k.float()).sum(dim=-1)
    return s[..., None] * v.float()


def wkv6(state, r, k, v, u, w, mask):
    """The V6 recurrence token by token. ``state`` [B, H, K, V]; ``r, k,
    w`` [B, T, H, K] (w activated); ``v`` [B, T, H, V]; ``u`` [H, K];
    ``mask`` [B, T] bool. Returns ``(y [B, T, H, V], new_state)``."""
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        y, S = wkv6_step(S, r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], u,
                         w[:, t:t + 1], mask[:, t:t + 1])
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1), S


def wkv6_step(state, r, k, v, u, w, mask):
    """One token of :func:`wkv6` (T = 1 inputs); the masked lanes keep
    their state."""
    rr, kk, vv, ww = (t[:, 0].float() for t in (r, k, v, w))
    kv = kk[..., :, None] * vv[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rr, u.float()[..., :, None] * kv + state)
    s_n = ww[..., :, None] * state + kv
    s = torch.where(mask[:, 0][:, None, None, None], s_n, state)
    return y[:, None], s


def wkv4_step(state, k, v, r, u, w, mask):
    """One V4 token. ``state`` [B, C, 3] (aa, bb, pp); ``k, v, r`` [B, 1,
    C] (r before the sigmoid); ``u`` (time_first), ``w`` (-exp(decay))
    [C]; ``mask`` [B, 1] bool. Returns ``(y [B, 1, C], new_state)``. A
    masked lane keeps its state by a select: pp may hold ``F32_MIN``."""
    kk, vv, rr = (t[:, 0].float() for t in (k, v, r))
    u, w = u.float(), w.float()
    aa, bb, pp = state[..., 0], state[..., 1], state[..., 2]
    ww = u + kk
    q = torch.maximum(pp, ww)
    e1, e2 = torch.exp(pp - q), torch.exp(ww - q)
    y = torch.sigmoid(rr) * (e1 * aa + e2 * vv) / (e1 * bb + e2)
    ww = w + pp
    q = torch.maximum(ww, kk)
    e1, e2 = torch.exp(ww - q), torch.exp(kk - q)
    m = mask[:, 0][:, None]
    new = torch.stack([torch.where(m, e1 * aa + e2 * vv, aa),
                       torch.where(m, e1 * bb + e2, bb),
                       torch.where(m, q, pp)], dim=-1)
    return y[:, None], new


def wkv4(state, k, v, r, u, w, mask):
    """The V4 recurrence token by token (:func:`wkv4_step`). ``k, v, r``
    [B, T, C]; ``mask`` [B, T] bool. Returns ``(y [B, T, C],
    new_state [B, C, 3])``."""
    s = state.float()
    ys = []
    for t in range(k.shape[1]):
        y, s = wkv4_step(s, k[:, t:t + 1], v[:, t:t + 1], r[:, t:t + 1], u, w,
                         mask[:, t:t + 1])
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1), s
