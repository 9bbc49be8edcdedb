"""RWKV-7 WKV recurrence in plain PyTorch — the ground truth of the port's
attention-core kernel (the chunk forms are ``ops/cuda/wkv7.wkv7_scan_plain``
and ``ops/wkv_chunked``).

Layout ``[B, T, ...]`` with a validity mask: masked (padding) steps
leave the recurrent state untouched. The state is one matrix S[K, V] per
head (K indexes key channels, V value channels).

    sa = Sᵀa;  S ← diag(w)S + k vᵀ + b saᵀ;  y = Sᵀr
    with a = -kk, b = kk ∘ a_ctrl, w = exp(-exp(-0.5)·sigmoid(w_in))
"""

from __future__ import annotations

import torch


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
