"""Chunk-parallel formulations of the RWKV-7 and RWKV-6 WKV, in PyTorch.

The prefill route for chunks of T ≥ 128 tokens (``models/forward.py``),
as in the JAX package, where it runs as XLA and not as a Pallas kernel:
here it is plain ``torch.matmul`` work, which on the card goes to cuBLAS
in full f32 (``forward_chunk`` switches TF32 off).

Sub-chunks of ``L`` tokens become dense matmuls and only the state is
carried between them. With ``P_t = w_1∘…∘w_t`` and ``Ŝ_t = diag(P_t)⁻¹ S_t``:

    b̂_t = b_t / P_t,  â_t = a_t ∘ P_{t-1},  k̂_t = k_t / P_t,  r̂_t = r_t ∘ P_t
    (I − strict_tril(Â B̂ᵀ)) U = Â Ŝ₀ + strict_tril(Â K̂ᵀ) V
    Y  = R̂ Ŝ₀ + tril(R̂ B̂ᵀ) U + tril(R̂ K̂ᵀ) V
    S_L = diag(P_L) (Ŝ₀ + B̂ᵀ U + K̂ᵀ V)

``1/P_t`` grows as decays accumulate, so L stays small (16: w ≥
exp(-e^{-0.5}) ≈ 0.545 ⇒ 1/P ≤ 1.7e4, safely inside f32). Padded
positions become identity steps (w = 1, k̂ = b̂ = â = 0), and their y is 0.

RWKV-6 (:func:`wkv6_chunked`) needs no solve: its transition is diagonal.
Its decays ``exp(-exp(w_raw))`` can be far smaller than V7's (a V6 decay
of 1e-9 is common), so ``1/P_t`` would leave f32 within a few tokens, as
the JAX package's ``wkv6_chunked`` does (it returns NaN there, for
example on decays ``exp(-exp(N(1, 0.8)))`` at T = 128). The port keeps
every decay ratio in log space, with exponents ≤ 0, and never forms
``1/P``.
"""

from __future__ import annotations

import torch

CHUNK = 16  # tokens per sub-chunk (see the module doc for the bound)


def _tri_solve_unit_lower(N: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``(I - N) U = rhs`` for strictly-lower-triangular ``N``
    ``[..., L, L]`` by blocked Neumann doubling (``(I-N)⁻¹ = Π (I +
    N^{2^i})``), exact for nilpotent N in ceil(log2 L) squarings."""
    L = N.shape[-1]
    inv = torch.eye(L, dtype=N.dtype, device=N.device) + N
    M = N
    for _ in range(max(1, (L - 1).bit_length()) - 1):
        M = M @ M
        inv = inv + M @ inv
    return inv @ rhs


def wkv7_chunked(state, r, w, k, v, a, b, mask):
    """Drop-in for the WKV scan (same layouts: ``state`` ``[B, H, K, V]``,
    ``r, w, k, a, b`` ``[B, T, H, K]`` with w activated, ``v``
    ``[B, T, H, V]``, ``mask`` ``[B, T]``); returns ``(y, new_state)``,
    f32."""
    f32 = torch.float32
    B, T, H, K = r.shape
    chunk = CHUNK
    pad = (-T) % chunk
    if pad:
        z = lambda x: torch.nn.functional.pad(  # noqa: E731
            x, (0, 0, 0, 0, 0, pad))
        r, w, k, v, a, b = map(z, (r, w, k, v, a, b))
        mask = torch.nn.functional.pad(mask.to(torch.uint8), (0, pad))
    Tp = T + pad
    n_chunks = Tp // chunk

    m = mask.bool()[..., None, None]
    r = r.to(f32) * m
    w = torch.where(m, w.to(f32), 1.0)
    k, v, a, b = (x.to(f32) * m for x in (k, v, a, b))

    def to_chunks(x):  # [B, Tp, H, D] -> [n, B, H, L, D]
        return x.reshape(B, n_chunks, chunk, H, -1).permute(1, 0, 3, 2, 4)

    rc, wc, kc, vc, ac, bc = map(to_chunks, (r, w, k, v, a, b))
    ones = torch.ones(chunk, chunk, dtype=f32, device=r.device)
    strict, incl = torch.tril(ones, diagonal=-1), torch.tril(ones)

    S = state.to(f32)
    ys = []
    for i in range(n_chunks):
        rr, ww, kk, vv, aa, bb = (x[i] for x in (rc, wc, kc, vc, ac, bc))
        P = torch.cumprod(ww, dim=2)  # [B, H, L, K]
        P_prev = P / ww
        inv_P = 1.0 / P
        a_h, b_h = aa * P_prev, bb * inv_P
        k_h, r_h = kk * inv_P, rr * P
        ab = (a_h @ b_h.transpose(-1, -2)) * strict
        ak = (a_h @ k_h.transpose(-1, -2)) * strict
        rb = (r_h @ b_h.transpose(-1, -2)) * incl
        rk = (r_h @ k_h.transpose(-1, -2)) * incl
        U = _tri_solve_unit_lower(ab, a_h @ S + ak @ vv)
        ys.append(r_h @ S + rb @ U + rk @ vv)
        S_hat = S + b_h.transpose(-1, -2) @ U + k_h.transpose(-1, -2) @ vv
        S = P[:, :, -1, :, None] * S_hat
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, Tp, H, -1)
    return y[:, :T], S


_TINY = float(torch.finfo(torch.float32).tiny)  # log(0) guard for decays that underflow


def wkv6_chunked(state, r, k, v, u, w, mask):
    """Drop-in for the V6 scan (layouts of ``ops/cuda/wkv6.wkv6_scan``:
    ``state`` ``[B, H, K, V]``, ``r, k, w`` ``[B, T, H, K]`` with w
    activated, ``v`` ``[B, T, H, V]``, ``u`` ``[H, K]``, ``mask``
    ``[B, T]``); returns ``(y, new_state)``, f32. Per sub-chunk of ``L``
    tokens, with ``λ_t = log w_t`` and ``Λ(a, b) = Σ_{a<t<b} λ_t``:

        y_i = (Σ_k r_i u k_i) v_i + Σ_{j<i} (Σ_k r_ik k_jk e^{Λ(j,i)}) v_j
              + (r_i ∘ e^{Λ(-1,i)})ᵀ S₀
        S_L = diag(e^{Λ(-1,L)}) S₀ + Σ_j (k_j ∘ e^{Λ(j,L)}) v_jᵀ

    Every exponent is a sum of logs of decays, so ≤ 0."""
    f32 = torch.float32
    B, T, H, K = r.shape
    chunk = CHUNK
    pad = (-T) % chunk
    if pad:
        z = lambda x: torch.nn.functional.pad(  # noqa: E731
            x, (0, 0, 0, 0, 0, pad))
        r, w, k, v = map(z, (r, w, k, v))
        mask = torch.nn.functional.pad(mask.to(torch.uint8), (0, pad))
    Tp = T + pad
    n_chunks = Tp // chunk

    m = mask.bool()[..., None, None]
    r, k, v = (x.to(f32) * m for x in (r, k, v))
    lw = torch.log(torch.where(m, w.to(f32), 1.0).clamp_min(_TINY))
    u = u.to(f32)

    def to_chunks(x):  # [B, Tp, H, D] -> [n, B, H, L, D]
        return x.reshape(B, n_chunks, chunk, H, -1).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lc = map(to_chunks, (r, k, v, lw))
    ones = torch.ones(chunk, chunk, dtype=f32, device=r.device)
    before = torch.tril(ones, diagonal=-1)  # [i, t]: t < i
    after = torch.triu(ones, diagonal=1)  # [j, t]: t > j
    between = before[:, None, :] * after[None, :, :]  # [i, j, t]: j < t < i

    S = state.to(f32)
    ys = []
    for c in range(n_chunks):
        rr, kk, vv, ll = rc[c], kc[c], vc[c], lc[c]
        decay_in = torch.exp(before @ ll)  # [B, H, L, K]: e^{Λ(-1, i)}
        decay_out = torch.exp(after @ ll)  # e^{Λ(j, L)}
        ratio = torch.exp(torch.einsum("ijt,bhtk->bhijk", between, ll))  # e^{Λ(j, i)}
        att = torch.einsum("bhik,bhjk,bhijk->bhij", rr, kk, ratio) * before
        bonus = (rr * u[:, None, :] * kk).sum(-1, keepdim=True) * vv
        ys.append(bonus + att @ vv + (rr * decay_in) @ S)
        S = torch.exp(ll.sum(2))[..., None] * S + (kk * decay_out).transpose(-1, -2) @ vv
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, Tp, H, -1)
    return y[:, :T], S
