"""Elementwise and normalization ops, in plain PyTorch on f32.

Variances are the population form (``correction=0``), as the model
defines them; ``torch.var``'s default is the unbiased one.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * w.float() + b.float()


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over the last axis split into ``num_groups`` groups
    (the per-head ``ln_x``, ``num_groups = num_head``, ``eps = 64e-5``).
    ``w``/``b`` are per-channel."""
    shape = x.shape
    c = shape[-1]
    x32 = x.float().reshape(shape[:-1] + (num_groups, c // num_groups))
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return y * w.float() + b.float()


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x * rsqrt(sum(x^2) + eps) over the last axis (per head for kk)."""
    x32 = x.float()
    ss = (x32 * x32).sum(dim=-1, keepdim=True)
    return x32 * torch.rsqrt(ss + eps)


def lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mix(a, b, t) = a + t*(b-a)."""
    return a + t * (b - a)


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    p = torch.clamp_min(x, 0.0)
    return p * p


def stable_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(-exp(x)): the V5/V6 decay activation."""
    return torch.exp(-torch.exp(x.float()))


def _previous(x: torch.Tensor, shift_state: torch.Tensor) -> torch.Tensor:
    """x shifted one token later along T, the shift state filling t=0."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def token_shift(
    x: torch.Tensor,  # [B, T, C] current (post-LN) activations
    shift_state: torch.Tensor,  # [B, C] last token of the previous chunk
    mix: torch.Tensor,  # [C] or [B, T, C] mix factor
    *,
    reversed_mix: bool,
) -> torch.Tensor:
    """Per-token lerp with the previous token (cross-chunk via shift_state).

    ``reversed_mix=False`` (V4/V5): out = mix(x_prev, x, factor)
    ``reversed_mix=True``  (V6/V7): out = mix(x, x_prev, factor)
    """
    x_prev = _previous(x, shift_state)
    if reversed_mix:
        return lerp(x, x_prev, mix)
    return lerp(x_prev, x, mix)


def token_shift_multi(
    x: torch.Tensor,  # [B, T, C]
    shift_state: torch.Tensor,  # [B, C]
    mixes: torch.Tensor,  # [S, C] stacked mix factors
) -> torch.Tensor:
    """All ``S`` reversed-mix token shifts of the same input in one lerp:
    ``[B, T, S, C]`` (V7's six shifts in r, w, k, v, a, g order)."""
    x_prev = _previous(x, shift_state)
    return lerp(x[:, :, None, :], x_prev[:, :, None, :], mixes[None, None])


def ddlerp(
    x: torch.Tensor,  # [B, T, C]
    shift_state: torch.Tensor,  # [B, C]
    mix_x: torch.Tensor,  # [C]
    time_mix: torch.Tensor,  # [5, C] static mixes (w, k, v, r, g)
    w1: torch.Tensor,  # [5R, C] adapter down
    w2: torch.Tensor,  # [5, C, R] adapter up
) -> torch.Tensor:
    """RWKV-6's data-dependent token shift: ``[B, T, 5, C]``, the w, k, v,
    r and g inputs. A reversed shift with ``mix_x`` feeds a rank-R tanh
    adapter whose outputs, plus ``time_mix``, are five per-token mixes of
    reversed shifts. The adapter products take operands in the weights'
    dtype and sum in f32."""
    x_prev = _previous(x, shift_state)
    sx = lerp(x, x_prev, mix_x)
    z = torch.tanh(sx.to(w1.dtype).float() @ w1.float().T).unflatten(-1, (5, -1))
    mix = torch.einsum("btfr,fcr->btfc", z.to(w2.dtype).float(), w2.float()) + time_mix
    return lerp(x[:, :, None, :], x_prev[:, :, None, :], mix)


def update_shift_state(
    x: torch.Tensor,  # [B, T, C]
    lengths: torch.Tensor,  # [B] number of valid tokens this chunk
    shift_state: torch.Tensor,  # [B, C] previous
) -> torch.Tensor:
    """New shift state = x at the last *valid* token; unchanged if len==0."""
    idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
    gathered = torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0, :]
    return torch.where((lengths > 0)[:, None], gathered, shift_state)
