"""RWKV-7, -6, -5 and -4 forward over ``[B, T]`` token chunks, eagerly in
PyTorch.

Padding tokens (``t >= lengths[b]``) never touch recurrent state. The
layers run in a Python loop over per-layer views of the parameters.

Routing, as in the JAX package (on the CPU each kernel wrapper takes its
plain version):

- T = 1 (decode) with params prepared by ``loader.prepare_decode`` (the
  Engine's) and at most ``MAX_SCAN_BATCH`` lanes: every layer in one
  launch of the whole-stack kernel, ``ops/cuda/layer7`` for RWKV-7,
  ``ops/cuda/layer56`` for RWKV-6, -5 and -4;
- quantized matmuls: the gemv kernels or the dequant-GEMM, by the row
  count (``Matrix.matmul``); with params unrolled by
  ``loader.unroll_params`` (the Engine's where no whole-stack block
  attaches), an RWKV-7 layer at T = 1 and one lane multiplies r, k and v
  in one ``quant_gemv_grouped`` launch where its quantized ``Wo`` and
  ``att["Wrkv_g"]`` say so (the JAX package's ``_fused_att_core_ok``
  gate without hooks);
- RWKV-7 at T = 1 otherwise: each layer's attention core is the fused
  att-core kernel; RWKV-6 at T = 1 otherwise: the WKV is the scan kernel
  ``wkv6_scan`` (where the JAX package runs an XLA step), so no plain
  version sits on a card path;
- 2 ≤ T < 128: the WKV runs as the scan kernel (``wkv7_scan``,
  ``wkv6_scan``), the rest of the layer as PyTorch ops;
- T ≥ 128: the WKV runs as the chunk-parallel ``ops/wkv_chunked``
  (PyTorch matmuls);
- RWKV-5 runs RWKV-6's WKV routes with its static decay broadcast over
  the tokens (``wkv6_scan`` at T < 128, T = 1 included, where the JAX
  package runs an XLA step); RWKV-4 has no chunk-parallel form, so its
  WKV is the scan kernel ``wkv4_scan`` at every T.

Dense matrices and the inner-LoRA adapters multiply with ``torch.matmul``
in f32 (bf16 operands where the weights are bf16); TF32 is switched off
when a CUDA input first arrives, so f32 products keep f32 precision.
"""

from __future__ import annotations

import torch

from ..ops import basic as B
from ..ops import wkv as W
from ..ops.cuda.layer7 import MAX_SCAN_BATCH, layer_scan7
from ..ops.cuda.layer56 import layer_scan56
from ..ops.cuda.matmul import quant_gemv_grouped
from ..ops.cuda.wkv4 import wkv4_scan
from ..ops.cuda.wkv6 import wkv6_scan
from ..ops.cuda.wkv7 import att_core7_step, wkv7_scan
from ..ops.wkv_chunked import wkv6_chunked, wkv7_chunked
from .info import ModelInfo, ModelVersion
from .loader import layer_params

LN_EPS = 1e-5
GN_EPS = 64.0e-5
L2_EPS = 1.0e-12
# chunks of at least this many tokens take the chunk-parallel WKV, shorter
# ones the scan kernel (the JAX package's crossover, models/forward.py;
# V6 uses it too)
WKV7_CHUNKED_MIN_T = 128


def init_state(info: ModelInfo, batch: int, device="cuda") -> dict:
    """Zero recurrent state, layer-stacked, all f32: shifts ``[L, B, C]``
    and the WKV matrices ``[L, B, H, hs, hs]`` (RWKV-7, -6 and -5); for
    RWKV-4 the shifts and its per-channel ``aa``, ``bb`` and ``pp``
    ``[L, B, C]``, pp at ``F32_MIN``."""
    L, C, H, hs = info.num_layer, info.num_emb, info.num_head, info.head_size
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    if info.version == ModelVersion.V4:
        return {"att_shift": z(L, batch, C), "aa": z(L, batch, C), "bb": z(L, batch, C),
                "pp": torch.full((L, batch, C), W.F32_MIN, device=device),
                "ffn_shift": z(L, batch, C)}
    return {
        "att_shift": z(L, batch, C),
        "wkv": z(L, batch, H, hs, hs),
        "ffn_shift": z(L, batch, C),
    }


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids → ln0-normalized embeddings in f32."""
    x = params["emb"][tokens.long()].float()
    return B.layer_norm(x, params["ln0"]["w"], params["ln0"]["b"], LN_EPS)


def logits_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm and the head matmul on the selected rows ``[B, C]``."""
    x = B.layer_norm(x, params["ln_out"]["w"], params["ln_out"]["b"], LN_EPS)
    return params["head"].matmul(x)


def _heads(x, H):
    return x.reshape(x.shape[0], x.shape[1], H, -1)


def _flat(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


def _lora(x, w_a, w_b, mid_act=None):
    """Adapter pair ``w_b · act(w_a · x)``: operands rounded to the
    adapters' dtype, products in f32."""
    z = x.to(w_a.dtype).float() @ w_a.float().T
    if mid_act is not None:
        z = mid_act(z)
    return z.to(w_b.dtype).float() @ w_b.float().T


def _wkv7(state, r, w, k, v, a, b, mask):
    """The delta rule over a chunk, routed by its length T."""
    if r.shape[1] >= WKV7_CHUNKED_MIN_T:
        return wkv7_chunked(state, r, w, k, v, a, b, mask)
    return wkv7_scan(state, r, w, k, v, a, b, mask)


def _wkv6(state, r, k, v, u, w, mask):
    """The V6 recurrence over a chunk, routed by its length T."""
    if r.shape[1] >= WKV7_CHUNKED_MIN_T:
        return wkv6_chunked(state, r, k, v, u, w, mask)
    return wkv6_scan(state, r, k, v, u, w, mask)


def _wkv5(state, r, k, v, u, w, mask):
    """The V5 recurrence over a chunk: V6's routes with the static decay
    ``w`` [H, K] broadcast over the tokens (a view, which the scan kernel
    reads in place)."""
    return _wkv6(state, r, k, v, u, w.expand(r.shape), mask)


def _att_core_composed(att, H, lst_wkv, r, w_in, k, v, a_in, g, mask):
    """The attention core over a chunk of T tokens: activations,
    control-k, the delta rule (:func:`_wkv7`), group norm, bonus, gate."""
    a = torch.sigmoid(a_in)
    kk = _flat(B.l2_normalize(_heads(k * att["k_k"], H), L2_EPS))
    k = k * (1.0 + (a - 1.0) * att["k_a"])
    rh, wh, kh, vh = (_heads(t, H) for t in (r, W.wkv7_act_w(w_in), k, v))
    kkh = _heads(kk, H)
    y, wkv = _wkv7(lst_wkv, rh, wh, kh, vh, -kkh, kkh * _heads(a, H), mask)
    y = B.group_norm(_flat(y), att["gn"]["w"], att["gn"]["b"], H, GN_EPS)
    y = y + _flat(W.wkv7_bonus(rh, kh, vh, att["r_k"]))
    return y * g, wkv


def _layer_v7(info, blk, lst, x, v0, layer_idx, mask, lengths):
    H = info.num_head
    att, ffn = blk["att"], blk["ffn"]
    xx = B.layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"], LN_EPS)
    sh = lst["att_shift"]
    rx, wx, kx, vx, ax, gx = B.token_shift_multi(xx, sh, att["x_stack"]).unbind(2)

    Bsz, T = x.shape[:2]
    if T == 1 and Bsz == 1 and "Wrkv_g" in att and att["Wo"].kind != "dense":
        m, k_in = att["Wr"].dims()
        xs = torch.stack([rx[:, 0], kx[:, 0], vx[:, 0]])
        r, k, v = quant_gemv_grouped(xs, att["Wr"].kind, att["Wrkv_g"], m, k_in)[:, :, None]
    else:
        r = att["Wr"].matmul(rx)
        k = att["Wk"].matmul(kx)
        v = att["Wv"].matmul(vx)
    w_in = att["w0"] + _lora(wx, att["w1"], att["w2"], torch.tanh)
    a_in = att["a0"] + _lora(ax, att["a1"], att["a2"])
    g = _lora(gx, att["g1"], att["g2"], torch.sigmoid)
    if layer_idx == 0:
        v0 = v
    else:  # value residual towards layer 0's v
        v_mix = torch.sigmoid(att["v0"] + _lora(vx, att["v1"], att["v2"]))
        v = v + v_mix * (v0 - v)

    if T == 1:
        hs = att["r_k"].shape[-1]
        y, wkv = att_core7_step(
            lst["wkv"], _heads(r, H)[:, 0], _heads(w_in, H)[:, 0],
            _heads(k, H)[:, 0], _heads(v, H)[:, 0], _heads(a_in, H)[:, 0],
            _heads(g, H)[:, 0], att["k_k"].reshape(H, hs),
            att["k_a"].reshape(H, hs), att["gn"]["w"].reshape(H, -1),
            att["gn"]["b"].reshape(H, -1), att["r_k"], mask[:, 0],
            GN_EPS, L2_EPS,
        )
        y = y.reshape(Bsz, 1, -1)
    else:
        y, wkv = _att_core_composed(att, H, lst["wkv"], r, w_in, k, v, a_in,
                                    g, mask)
    x = x + att["Wo"].matmul(y)

    xx2 = B.layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"], LN_EPS)
    kx2 = B.token_shift(xx2, lst["ffn_shift"], ffn["x_k"], reversed_mix=True)
    x = x + ffn["Wv"].matmul(B.squared_relu(ffn["Wk"].matmul(kx2)))

    new = {
        "att_shift": B.update_shift_state(xx, lengths, sh),
        "wkv": wkv,
        "ffn_shift": B.update_shift_state(xx2, lengths, lst["ffn_shift"]),
    }
    return x, v0, new


def _layer_v6(info, blk, lst, x, mask, lengths):
    H = info.num_head
    att, ffn = blk["att"], blk["ffn"]
    xx = B.layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"], LN_EPS)
    sh = lst["att_shift"]
    wx, kx, vx, rx, gx = B.ddlerp(xx, sh, att["mix_x"], att["time_mix"], att["tm_w1"],
                                  att["tm_w2"]).unbind(2)
    k = att["Wk"].matmul(kx)
    v = att["Wv"].matmul(vx)
    r = att["Wr"].matmul(rx)
    g = att["Wg"].matmul(gx)
    w = B.stable_exp(att["time_decay"] + _lora(wx, att["td_w1"], att["td_w2"], torch.tanh))
    y, wkv = _wkv6(lst["wkv"], _heads(r, H), _heads(k, H), _heads(v, H), att["time_first"],
                   _heads(w, H), mask)
    y = B.group_norm(_flat(y), att["gn"]["w"], att["gn"]["b"], H, GN_EPS)
    x = x + att["Wo"].matmul(y * (g * torch.sigmoid(g)))

    xx2 = B.layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"], LN_EPS)
    kx2 = B.token_shift(xx2, lst["ffn_shift"], ffn["mix_k"], reversed_mix=True)
    rx2 = B.token_shift(xx2, lst["ffn_shift"], ffn["mix_r"], reversed_mix=True)
    vf = ffn["Wv"].matmul(B.squared_relu(ffn["Wk"].matmul(kx2)))
    x = x + torch.sigmoid(ffn["Wr"].matmul(rx2)) * vf

    new = {
        "att_shift": B.update_shift_state(xx, lengths, sh),
        "wkv": wkv,
        "ffn_shift": B.update_shift_state(xx2, lengths, lst["ffn_shift"]),
    }
    return x, new


def _ffn_v4(ffn, xx2, shift, lengths):
    """The RWKV-5 and RWKV-4 FFN: non-reversed shifts, the squared-ReLU
    key, the sigmoid receptance gate. Returns ``(out, new_shift)``."""
    kx = B.token_shift(xx2, shift, ffn["mix_k"], reversed_mix=False)
    rx = B.token_shift(xx2, shift, ffn["mix_r"], reversed_mix=False)
    vf = ffn["Wv"].matmul(B.squared_relu(ffn["Wk"].matmul(kx)))
    out = torch.sigmoid(ffn["Wr"].matmul(rx)) * vf
    return out, B.update_shift_state(xx2, lengths, shift)


def _layer_v5(info, blk, lst, x, mask, lengths):
    H = info.num_head
    att, ffn = blk["att"], blk["ffn"]
    xx = B.layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"], LN_EPS)
    sh = lst["att_shift"]
    kx, vx, rx, gx = (B.token_shift(xx, sh, att["mix_" + s], reversed_mix=False)
                      for s in "kvrg")
    k = att["Wk"].matmul(kx)
    v = att["Wv"].matmul(vx)
    r = att["Wr"].matmul(rx)
    g = att["Wg"].matmul(gx)
    y, wkv = _wkv5(lst["wkv"], _heads(r, H), _heads(k, H), _heads(v, H), att["time_first"],
                   att["time_decay"], mask)
    y = B.group_norm(_flat(y), att["gn"]["w"], att["gn"]["b"], H, GN_EPS)
    x = x + att["Wo"].matmul(y * (g * torch.sigmoid(g)))

    xx2 = B.layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"], LN_EPS)
    out, ffn_shift = _ffn_v4(ffn, xx2, lst["ffn_shift"], lengths)
    new = {"att_shift": B.update_shift_state(xx, lengths, sh), "wkv": wkv,
           "ffn_shift": ffn_shift}
    return x + out, new


def _layer_v4(info, blk, lst, x, mask, lengths):
    att, ffn = blk["att"], blk["ffn"]
    xx = B.layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"], LN_EPS)
    sh = lst["att_shift"]
    kx, vx, rx = (B.token_shift(xx, sh, att["mix_" + s], reversed_mix=False) for s in "kvr")
    k = att["Wk"].matmul(kx)
    v = att["Wv"].matmul(vx)
    r = att["Wr"].matmul(rx)
    state4 = torch.stack([lst["aa"], lst["bb"], lst["pp"]], dim=-1)
    y, state4 = wkv4_scan(state4, k, v, r, att["time_first"], att["time_decay"], mask)
    x = x + att["Wo"].matmul(y)

    xx2 = B.layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"], LN_EPS)
    out, ffn_shift = _ffn_v4(ffn, xx2, lst["ffn_shift"], lengths)
    new = {"att_shift": B.update_shift_state(xx, lengths, sh), "aa": state4[..., 0],
           "bb": state4[..., 1], "pp": state4[..., 2], "ffn_shift": ffn_shift}
    return x + out, new


_LAYERS = {ModelVersion.V6: _layer_v6, ModelVersion.V5: _layer_v5, ModelVersion.V4: _layer_v4}


def _forward(info, params, layers, state, tokens, lengths, rescale):
    T = tokens.shape[1]
    if tokens.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    mask = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
    x = embed_tokens(params, tokens)
    x = torch.where(mask[..., None], x, 0.0)
    L = info.num_layer
    do_rescale = rescale is not None and rescale < L
    if T == 1 and tokens.shape[0] <= MAX_SCAN_BATCH:
        if "mega7" in params:
            xo, new_state = layer_scan7(params["mega7"], state, x[:, 0], mask[:, 0],
                                        rescale if do_rescale else None, LN_EPS, GN_EPS,
                                        L2_EPS)
            return xo[:, None], new_state
        if "mega56" in params:
            xo, new_state = layer_scan56(params["mega56"], state, x[:, 0], mask[:, 0],
                                         rescale if do_rescale else None, LN_EPS, GN_EPS)
            return xo[:, None], new_state
    v0 = None
    news = []
    for i in range(L):
        lst = {key: a[i] for key, a in state.items()}
        if info.version == ModelVersion.V7:
            x, v0, new = _layer_v7(info, layers[i], lst, x, v0, i, mask, lengths)
        else:
            x, new = _LAYERS[info.version](info, layers[i], lst, x, mask, lengths)
        if do_rescale and (i + 1) % rescale == 0:
            x = x * 0.5
        news.append(new)
    new_state = {key: torch.stack([n[key] for n in news]) for key in state}
    return x, new_state


def forward_chunk(
    info: ModelInfo,
    params: dict,
    state: dict,
    tokens: torch.Tensor,  # [B, T] int
    lengths: torch.Tensor,  # [B] int valid token counts
    *,
    rescale: int | None = None,
) -> tuple[torch.Tensor, dict]:
    """Run one chunk through all layers.

    Returns ``(x, new_state)``: ``x`` is the final residual stream
    ``[B, T, C]`` in f32 (apply :func:`logits_head` to selected rows; x
    at a padded position is unspecified);
    ``new_state`` is a new dict, the input state is left as it was.
    ``rescale`` halves the residual every N layers, matching a model
    loaded with the same ``rescale``.
    """
    return _forward(info, params, layer_params(params, info.num_layer), state,
                    tokens, lengths, rescale)
