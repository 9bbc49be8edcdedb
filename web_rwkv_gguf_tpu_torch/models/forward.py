"""RWKV-7, -6, -5 and -4 forward over ``[B, T]`` token chunks, eagerly in
PyTorch.

Padding tokens (``t >= lengths[b]``) never touch recurrent state. The
layers run in a Python loop over per-layer views of the parameters.

Routing, as in the JAX package (on the CPU each kernel wrapper takes its
plain version):

- T = 1 (decode) with params prepared by ``loader.prepare_decode`` (the
  Engine's), at most ``MAX_SCAN_BATCH`` lanes and ``hooks=None``: every
  layer in one launch of the whole-stack kernel, ``ops/cuda/layer7`` for
  RWKV-7, ``ops/cuda/layer56`` for RWKV-6, -5 and -4;
- quantized matmuls: the gemv kernels or the dequant-GEMM, by the row
  count (``Matrix.matmul``); with params unrolled by
  ``loader.unroll_params`` (the Engine's where no whole-stack block
  attaches), an RWKV-7 layer at T = 1 and one lane multiplies r, k and v
  in one ``quant_gemv_grouped`` launch where its quantized ``Wo`` and
  ``att["Wrkv_g"]`` say so (the JAX package's ``_fused_att_core_ok``
  gate without hooks);
- RWKV-7 at T = 1 otherwise: each layer's attention core is the fused
  att-core kernel, unless a hook is given (then the composed core, its
  WKV the scan kernel ``wkv7_scan`` at T = 1, so that every tap fires);
  RWKV-6 at T = 1 otherwise: the WKV is the scan kernel ``wkv6_scan``
  (where the JAX package runs an XLA step), so no plain version sits on a
  card path;
- 2 ≤ T < 128: the WKV runs as the scan kernel (``wkv7_scan``,
  ``wkv6_scan``), the rest of the layer as PyTorch ops;
- T ≥ 128: the WKV runs as the chunk-parallel ``ops/wkv_chunked``
  (PyTorch matmuls);
- RWKV-5 runs RWKV-6's WKV routes with its static decay broadcast over
  the tokens (``wkv6_scan`` at T < 128, T = 1 included, where the JAX
  package runs an XLA step); RWKV-4 has no chunk-parallel form, so its
  WKV is the scan kernel ``wkv4_scan`` at every T.

Hooks (:class:`HookCtx`, :data:`HOOK_NAMES`) follow the JAX package:
any ``hooks`` that is not None runs the per-layer loop; a non-empty one
also leaves the fused att-core kernel and the grouped r/k/v gemv, so
that every tap sits on a tensor of the composed layer.

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


class _NoHook:
    """The default tap: hands the tensors back as they are."""

    __slots__ = ()

    def __call__(self, name, **tensors):
        return tensors


_NOHOOK = _NoHook()


class HookCtx:
    """One layer's taps (the JAX package's ``HookCtx``; ref: the Hook
    enums of src/runtime/v4.rs-v7.rs).

    ``hooks`` maps tap names to ``fn(layer, **tensors) -> dict | None``;
    the entries of a returned dict replace the named tensors, so a hook
    can observe and modify. Names are the reference's variants in
    snake_case, listed per version in :data:`HOOK_NAMES`. The model-level
    taps (``post_embed_loaded``, ``post_embed_layer_norm``, ``pre_head``,
    ``post_head_layer_norm``, ``post_head``) fire with layer -1;
    ``post_embed`` is a legacy alias of ``post_embed_layer_norm`` and
    ``pre_att_decay_activate`` of ``pre_att_time_decay_activate`` (RWKV-6:
    the raw decay ``w`` [B, T, C] and ``k`` [B, T, H, hs]).

    Under a CUDA graph (``runtime/graph.py``; an ``Engine`` or
    ``make_generator`` on a card by default) a hook keeps the JAX
    package's contract, where a hook is traced once into the jitted step:

    - a hook is a function of tensors, made of device ops;
    - its Python body runs when the step is warmed up and captured, never
      at a replay, so host work in it (a count, a list of what fired)
      happens at the capture only;
    - a hook that reads the host (``.item()``, ``.cpu()``,
      ``bool(tensor)``, or ``torch.tensor(list, device="cuda")`` inside
      the step) must run with ``graph=False``: on a graph its capture
      fails, and the step raises ``UnsupportedFeature``, naming
      ``graph=False``. It never falls back to the eager step."""

    def __init__(self, hooks: dict, layer: int):
        self.hooks = hooks
        self.layer = layer

    def __call__(self, name, **tensors):
        fn = self.hooks.get(name)
        if fn is not None:
            out = fn(self.layer, **tensors)
            if out:
                tensors.update(out)
        return tensors


# every tap, per version: the reference's Hook variants (v4.rs:307-334,
# 26; v5.rs:335-364, 28; v6.rs:367-406, 38; v7.rs:386-421, 34)
_HOOKS_COMMON = (
    "post_embed_loaded", "post_embed_layer_norm",
    "pre_att", "post_att_layer_norm",
    "pre_att_token_shift", "post_att_token_shift",
    "pre_att_linear", "post_att_linear",
    "pre_att_time_mix", "post_att_time_mix",
    "pre_att_out", "post_att_out", "post_att",
    "pre_ffn", "post_ffn_layer_norm",
    "pre_ffn_token_shift", "post_ffn_token_shift",
    "pre_ffn_linear", "post_ffn_linear", "post_ffn_activate",
    "pre_ffn_channel_mix", "post_ffn_channel_mix", "post_ffn",
    "pre_head", "post_head_layer_norm", "post_head",
)
_HOOKS_GATE = ("pre_att_gate", "post_att_gate")
HOOK_NAMES = {
    ModelVersion.V4: _HOOKS_COMMON,
    ModelVersion.V5: _HOOKS_COMMON + _HOOKS_GATE,
    ModelVersion.V6: _HOOKS_COMMON + _HOOKS_GATE + (
        "pre_att_token_shift_adapt", "post_att_token_shift_adapt",
        "post_att_token_shift_adapt_activate",
        "pre_att_gated_token_shift", "post_att_gated_token_shift",
        "pre_att_time_decay_adapt", "post_att_time_decay_adapt",
        "post_att_time_decay_adapt_activate",
        "pre_att_time_decay_activate", "post_att_time_decay_activate",
    ),
    ModelVersion.V7: _HOOKS_COMMON + _HOOKS_GATE + (
        "pre_att_adapt", "post_att_adapt",
        "pre_att_control", "post_att_control",
        "pre_att_value_residual", "post_att_value_residual",
    ),
}


def _hook_ctx(hooks, layer):
    """The taps of ``layer``: :data:`_NOHOOK` where ``hooks`` is None or
    empty, so that no tap changes the route or the numbers."""
    return HookCtx(hooks, layer) if hooks else _NOHOOK


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids → ln0-normalized embeddings in f32."""
    x = params["emb"][tokens.long()].float()
    return B.layer_norm(x, params["ln0"]["w"], params["ln0"]["b"], LN_EPS)


def logits_head(params: dict, x: torch.Tensor, hooks: dict | None = None) -> torch.Tensor:
    """Final LayerNorm and the head matmul on the selected rows ``[B, C]``.
    ``hooks`` taps ``post_head_layer_norm`` and ``post_head`` (layer -1);
    ``pre_head`` fires at the end of :func:`forward_chunk`."""
    hk = _hook_ctx(hooks, -1)
    x = B.layer_norm(x, params["ln_out"]["w"], params["ln_out"]["b"], LN_EPS)
    x = hk("post_head_layer_norm", x=x)["x"]
    return hk("post_head", x=params["head"].matmul(x))["x"]


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


def _wkv4(state, k, v, r, u, w, mask):
    """The V4 recurrence over a chunk: the scan kernel at every T."""
    return wkv4_scan(state, k, v, r, u, w, mask)


_WKV = {ModelVersion.V7: _wkv7, ModelVersion.V6: _wkv6, ModelVersion.V5: _wkv5,
        ModelVersion.V4: _wkv4}


class Block:
    """Where a chunk's tokens sit in their sequence, as a layer sees it:
    the whole rest of the sequence after the carried state. The token
    before the chunk's first is the carried shift row (:meth:`previous`),
    and the WKV runs from the carried state (:meth:`wkv`, the router of
    the model's version). ``parallel/sequence.py`` splits one chunk over
    ranks by overriding both."""

    def previous(self, xx: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
        """The row ``[B, C]`` before the chunk's first token of ``xx``."""
        return shift

    def wkv(self, version: ModelVersion, state, *args):
        """``(y, new_state)`` of the version's WKV over the chunk."""
        return _WKV[version](state, *args)


WHOLE = Block()


def _v7_control(att, H, k, a, w_in, hk):
    """Control-k: the l2-normalized ``kk`` and the k that the delta rule
    takes, between the JAX package's ``pre/post_att_control`` taps.
    Returns ``(k, kk, a, w_in)`` as the taps leave them."""
    t = hk("pre_att_control", k=k, a=a, w=w_in)
    k, a, w_in = t["k"], t["a"], t["w"]
    kk = _flat(B.l2_normalize(_heads(k * att["k_k"], H), L2_EPS))
    k = k * (1.0 + (a - 1.0) * att["k_a"])
    # a and the raw w are exposed so that a hook can change the WKV's
    # b term after control-k (the othello example's a <- act_w(w)·a)
    t = hk("post_att_control", k=k, kk=kk, a=a, w=w_in)
    return t["k"], t["kk"], t["a"], w_in


def _value_residual(att, vx, v, v0, layer_idx):
    """``(v, v0)``: layer 0's v becomes v0; a later layer's v moves
    towards it by its v-adapter's mix."""
    if layer_idx == 0:
        return v, v
    v_mix = torch.sigmoid(att["v0"] + _lora(vx, att["v1"], att["v2"]))
    return v + v_mix * (v0 - v), v0


def _layer_v7(info, blk, lst, x, v0, layer_idx, mask, lengths, hk=_NOHOOK,
              block=WHOLE):
    H = info.num_head
    att, ffn = blk["att"], blk["ffn"]
    x = hk("pre_att", x=x)["x"]
    xx = B.layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"], LN_EPS)
    xx = hk("post_att_layer_norm", x=xx)["x"]
    xx = hk("pre_att_token_shift", x=xx)["x"]
    sh = block.previous(xx, lst["att_shift"])
    rx, wx, kx, vx, ax, gx = B.token_shift_multi(xx, sh, att["x_stack"]).unbind(2)
    t = hk("post_att_token_shift", rx=rx, wx=wx, kx=kx, vx=vx, ax=ax, gx=gx)
    rx, wx, kx, vx, ax, gx = (t[n] for n in ("rx", "wx", "kx", "vx", "ax", "gx"))
    t = hk("pre_att_linear", rx=rx, kx=kx, vx=vx)
    rx, kx, vx = t["rx"], t["kx"], t["vx"]

    Bsz, T = x.shape[:2]
    # the fused kernels take what no tap may see (the JAX package's
    # _fused_att_core_ok): only without hooks
    fused = T == 1 and hk is _NOHOOK
    if fused and Bsz == 1 and "Wrkv_g" in att and att["Wo"].kind != "dense":
        m, k_in = att["Wr"].dims()
        xs = torch.stack([rx[:, 0], kx[:, 0], vx[:, 0]])
        r, k, v = quant_gemv_grouped(xs, att["Wr"].kind, att["Wrkv_g"], m, k_in)[:, :, None]
    else:
        r = att["Wr"].matmul(rx)
        k = att["Wk"].matmul(kx)
        v = att["Wv"].matmul(vx)
    t = hk("post_att_linear", r=r, k=k, v=v)
    r, k, v = t["r"], t["k"], t["v"]
    t = hk("pre_att_adapt", wx=wx, ax=ax, gx=gx, vx=vx)
    wx, ax, gx, vx = t["wx"], t["ax"], t["gx"], t["vx"]
    w_in = att["w0"] + _lora(wx, att["w1"], att["w2"], torch.tanh)
    a_in = att["a0"] + _lora(ax, att["a1"], att["a2"])
    g = _lora(gx, att["g1"], att["g2"], torch.sigmoid)

    if fused:
        v, v0 = _value_residual(att, vx, v, v0, layer_idx)
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
        # the composed core: activations, control-k, value residual, the
        # delta rule, group norm, bonus, gate, each tap where the JAX
        # package's hooked layer has it (_v7_mix_inputs)
        t = hk("post_att_adapt", w=w_in, a=torch.sigmoid(a_in), g=g)
        w_in, a, g = t["w"], t["a"], t["g"]
        k, kk, a, w_in = _v7_control(att, H, k, a, w_in, hk)
        v, v0 = _value_residual(att, vx, hk("pre_att_value_residual", v=v)["v"], v0,
                                layer_idx)
        v = hk("post_att_value_residual", v=v)["v"]
        rh, wh, kh, vh = (_heads(t_, H) for t_ in (r, W.wkv7_act_w(w_in), k, v))
        kkh = _heads(kk, H)
        t = hk("pre_att_time_mix", r=rh, w=wh, k=kh, v=vh, a=-kkh, b=kkh * _heads(a, H))
        rh, kh, vh = t["r"], t["k"], t["v"]
        y, wkv = block.wkv(info.version, lst["wkv"], rh, t["w"], kh, vh, t["a"], t["b"],
                           mask)
        y = B.group_norm(_flat(y), att["gn"]["w"], att["gn"]["b"], H, GN_EPS)
        y = y + _flat(W.wkv7_bonus(rh, kh, vh, att["r_k"]))
        y = hk("post_att_time_mix", x=y)["x"]
        t = hk("pre_att_gate", x=y, g=g)
        y = hk("post_att_gate", x=t["x"] * t["g"])["x"]
    x = _att_out(att, x, y, hk)

    x = hk("pre_ffn", x=x)["x"]
    xx2 = B.layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"], LN_EPS)
    xx2 = hk("post_ffn_layer_norm", x=xx2)["x"]
    xx2 = hk("pre_ffn_token_shift", x=xx2)["x"]
    sh2 = block.previous(xx2, lst["ffn_shift"])
    kx2 = B.token_shift(xx2, sh2, ffn["x_k"], reversed_mix=True)
    kx2 = hk("post_ffn_token_shift", kx=kx2)["kx"]
    kx2 = hk("pre_ffn_linear", kx=kx2)["kx"]
    kf = hk("post_ffn_linear", k=ffn["Wk"].matmul(kx2))["k"]
    kf = hk("post_ffn_activate", k=B.squared_relu(kf))["k"]
    vf = hk("pre_ffn_channel_mix", v=ffn["Wv"].matmul(kf))["v"]
    vf = hk("post_ffn_channel_mix", x=vf)["x"]
    x = hk("post_ffn", x=x + vf)["x"]

    new = {
        "att_shift": B.update_shift_state(xx, lengths, sh),
        "wkv": wkv,
        "ffn_shift": B.update_shift_state(xx2, lengths, sh2),
    }
    return x, v0, new


def _att_out(att, x, y, hk):
    """The attention output and the residual add, with their taps."""
    y = hk("pre_att_out", x=y)["x"]
    dx = hk("post_att_out", x=att["Wo"].matmul(y))["x"]
    return hk("post_att", x=x + dx)["x"]


def _ddlerp(xx, sh, att, hk):
    """RWKV-6's data-dependent token shift, :func:`ops.basic.ddlerp`'s ops
    one by one with the JAX package's taps between them: the w, k, v, r
    and g inputs."""
    x_prev = B._previous(xx, sh)
    sx = hk("post_att_token_shift", x=B.lerp(xx, x_prev, att["mix_x"]))["x"]
    sx = hk("pre_att_token_shift_adapt", x=sx)["x"]
    w1, w2 = att["tm_w1"], att["tm_w2"]
    z = hk("post_att_token_shift_adapt", x=sx.to(w1.dtype).float() @ w1.float().T)["x"]
    z = hk("post_att_token_shift_adapt_activate", x=torch.tanh(z))["x"].unflatten(-1, (5, -1))
    mix = torch.einsum("btfr,fcr->btfc", z.to(w2.dtype).float(), w2.float()) + att["time_mix"]
    mix = hk("pre_att_gated_token_shift", mix=mix)["mix"]
    shifts = B.lerp(xx[:, :, None, :], x_prev[:, :, None, :], mix).unbind(2)
    t = hk("post_att_gated_token_shift", **dict(zip(("wx", "kx", "vx", "rx", "gx"), shifts)))
    return [t[n] for n in ("wx", "kx", "vx", "rx", "gx")]


def _att_gate(y, g, hk):
    """RWKV-6/5's gate ``y · silu(g)`` with its taps."""
    y = hk("post_att_time_mix", x=y)["x"]
    t = hk("pre_att_gate", x=y, g=g)
    g = t["g"]
    return hk("post_att_gate", x=t["x"] * (g * torch.sigmoid(g)))["x"]


def _layer_v6(info, blk, lst, x, mask, lengths, hk=_NOHOOK, block=WHOLE):
    H = info.num_head
    att, ffn = blk["att"], blk["ffn"]
    x = hk("pre_att", x=x)["x"]
    xx = B.layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"], LN_EPS)
    xx = hk("post_att_layer_norm", x=xx)["x"]
    xx = hk("pre_att_token_shift", x=xx)["x"]
    sh = block.previous(xx, lst["att_shift"])
    wx, kx, vx, rx, gx = _ddlerp(xx, sh, att, hk)
    t = hk("pre_att_linear", wx=wx, kx=kx, vx=vx, rx=rx, gx=gx)
    wx, kx, vx, rx, gx = t["wx"], t["kx"], t["vx"], t["rx"], t["gx"]
    k = att["Wk"].matmul(kx)
    v = att["Wv"].matmul(vx)
    r = att["Wr"].matmul(rx)
    g = att["Wg"].matmul(gx)
    t = hk("post_att_linear", k=k, v=v, r=r, g=g)
    k, v, r, g = _heads(t["k"], H), _heads(t["v"], H), _heads(t["r"], H), t["g"]
    wx = hk("pre_att_time_decay_adapt", x=wx)["x"]
    w1, w2 = att["td_w1"], att["td_w2"]
    dz = hk("post_att_time_decay_adapt", x=wx.to(w1.dtype).float() @ w1.float().T)["x"]
    dz = hk("post_att_time_decay_adapt_activate", x=torch.tanh(dz))["x"]
    w_raw = att["time_decay"] + dz.to(w2.dtype).float() @ w2.float().T
    # the raw decay and k (the puzzle15 example's k <- exp(min(w, 0))·k);
    # "pre_att_decay_activate" is the legacy alias of the same tap
    t = hk("pre_att_decay_activate", w=w_raw, k=k)
    t = hk("pre_att_time_decay_activate", w=t["w"], k=t["k"])
    w_raw, k = t["w"], t["k"]
    w = hk("post_att_time_decay_activate", w=_heads(B.stable_exp(w_raw), H))["w"]
    t = hk("pre_att_time_mix", r=r, k=k, v=v, w=w)
    y, wkv = block.wkv(info.version, lst["wkv"], t["r"], t["k"], t["v"], att["time_first"],
                       t["w"], mask)
    y = B.group_norm(_flat(y), att["gn"]["w"], att["gn"]["b"], H, GN_EPS)
    x = _att_out(att, x, _att_gate(y, g, hk), hk)

    x = hk("pre_ffn", x=x)["x"]
    xx2 = B.layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"], LN_EPS)
    xx2 = hk("post_ffn_layer_norm", x=xx2)["x"]
    out, ffn_shift = _ffn(ffn, xx2, block.previous(xx2, lst["ffn_shift"]), lengths, True, hk)
    new = {"att_shift": B.update_shift_state(xx, lengths, sh), "wkv": wkv,
           "ffn_shift": ffn_shift}
    return hk("post_ffn", x=x + out)["x"], new


def _ffn(ffn, xx2, shift, lengths, reversed_mix, hk):
    """The RWKV-6, -5 and -4 FFN (RWKV-6's shifts reversed): the
    squared-ReLU key, the sigmoid receptance gate. Returns ``(out,
    new_shift)``."""
    xx2 = hk("pre_ffn_token_shift", x=xx2)["x"]
    kx = B.token_shift(xx2, shift, ffn["mix_k"], reversed_mix=reversed_mix)
    rx = B.token_shift(xx2, shift, ffn["mix_r"], reversed_mix=reversed_mix)
    t = hk("post_ffn_token_shift", kx=kx, rx=rx)
    t = hk("pre_ffn_linear", kx=t["kx"], rx=t["rx"])
    t = hk("post_ffn_linear", k=ffn["Wk"].matmul(t["kx"]), r=ffn["Wr"].matmul(t["rx"]))
    r = t["r"]
    kf = hk("post_ffn_activate", k=B.squared_relu(t["k"]))["k"]
    t = hk("pre_ffn_channel_mix", r=r, v=ffn["Wv"].matmul(kf))
    out = hk("post_ffn_channel_mix", x=torch.sigmoid(t["r"]) * t["v"])["x"]
    return out, B.update_shift_state(xx2, lengths, shift)


def _layer_v5(info, blk, lst, x, mask, lengths, hk=_NOHOOK, block=WHOLE):
    H = info.num_head
    att, ffn = blk["att"], blk["ffn"]
    x = hk("pre_att", x=x)["x"]
    xx = B.layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"], LN_EPS)
    xx = hk("post_att_layer_norm", x=xx)["x"]
    xx = hk("pre_att_token_shift", x=xx)["x"]
    sh = block.previous(xx, lst["att_shift"])
    kx, vx, rx, gx = (B.token_shift(xx, sh, att["mix_" + s], reversed_mix=False)
                      for s in "kvrg")
    t = hk("post_att_token_shift", kx=kx, vx=vx, rx=rx, gx=gx)
    t = hk("pre_att_linear", kx=t["kx"], vx=t["vx"], rx=t["rx"], gx=t["gx"])
    k = att["Wk"].matmul(t["kx"])
    v = att["Wv"].matmul(t["vx"])
    r = att["Wr"].matmul(t["rx"])
    g = att["Wg"].matmul(t["gx"])
    t = hk("post_att_linear", k=k, v=v, r=r, g=g)
    t = hk("pre_att_time_mix", k=t["k"], v=t["v"], r=t["r"], g=t["g"])
    y, wkv = block.wkv(info.version, lst["wkv"], _heads(t["r"], H), _heads(t["k"], H),
                       _heads(t["v"], H), att["time_first"], att["time_decay"], mask)
    y = B.group_norm(_flat(y), att["gn"]["w"], att["gn"]["b"], H, GN_EPS)
    x = _att_out(att, x, _att_gate(y, t["g"], hk), hk)

    x = hk("pre_ffn", x=x)["x"]
    xx2 = B.layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"], LN_EPS)
    xx2 = hk("post_ffn_layer_norm", x=xx2)["x"]
    out, ffn_shift = _ffn(ffn, xx2, block.previous(xx2, lst["ffn_shift"]), lengths, False, hk)
    new = {"att_shift": B.update_shift_state(xx, lengths, sh), "wkv": wkv,
           "ffn_shift": ffn_shift}
    return hk("post_ffn", x=x + out)["x"], new


def _layer_v4(info, blk, lst, x, mask, lengths, hk=_NOHOOK, block=WHOLE):
    att, ffn = blk["att"], blk["ffn"]
    x = hk("pre_att", x=x)["x"]
    xx = B.layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"], LN_EPS)
    xx = hk("post_att_layer_norm", x=xx)["x"]
    xx = hk("pre_att_token_shift", x=xx)["x"]
    sh = block.previous(xx, lst["att_shift"])
    kx, vx, rx = (B.token_shift(xx, sh, att["mix_" + s], reversed_mix=False) for s in "kvr")
    t = hk("post_att_token_shift", kx=kx, vx=vx, rx=rx)
    t = hk("pre_att_linear", kx=t["kx"], vx=t["vx"], rx=t["rx"])
    k = att["Wk"].matmul(t["kx"])
    v = att["Wv"].matmul(t["vx"])
    r = att["Wr"].matmul(t["rx"])
    t = hk("post_att_linear", k=k, v=v, r=r)
    t = hk("pre_att_time_mix", k=t["k"], v=t["v"], r=t["r"])
    state4 = torch.stack([lst["aa"], lst["bb"], lst["pp"]], dim=-1)
    y, state4 = block.wkv(info.version, state4, t["k"], t["v"], t["r"], att["time_first"],
                          att["time_decay"], mask)
    x = _att_out(att, x, hk("post_att_time_mix", x=y)["x"], hk)

    x = hk("pre_ffn", x=x)["x"]
    xx2 = B.layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"], LN_EPS)
    xx2 = hk("post_ffn_layer_norm", x=xx2)["x"]
    out, ffn_shift = _ffn(ffn, xx2, block.previous(xx2, lst["ffn_shift"]), lengths, False, hk)
    new = {"att_shift": B.update_shift_state(xx, lengths, sh), "aa": state4[..., 0],
           "bb": state4[..., 1], "pp": state4[..., 2], "ffn_shift": ffn_shift}
    return hk("post_ffn", x=x + out)["x"], new


_LAYERS = {ModelVersion.V6: _layer_v6, ModelVersion.V5: _layer_v5, ModelVersion.V4: _layer_v4}


def _forward(info, params, layers, state, tokens, lengths, rescale, hooks=None,
             input_embeds=None):
    """:func:`forward_chunk` on the per-layer views ``layers``."""
    if input_embeds is not None:
        x = input_embeds.float()
    else:
        x = params["emb"][tokens.long()].float()
    B_, T = x.shape[:2]
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    mask = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    top = _hook_ctx(hooks, -1)
    # the embedding rows before ln0 (ref: Hook::PostEmbedLoaded)
    x = top("post_embed_loaded", x=x)["x"]
    x = B.layer_norm(x, params["ln0"]["w"], params["ln0"]["b"], LN_EPS)
    x = torch.where(mask[..., None], x, 0.0)
    L = info.num_layer
    do_rescale = rescale is not None and rescale < L
    if T == 1 and B_ <= MAX_SCAN_BATCH and hooks is None:
        if "mega7" in params:
            xo, new_state = layer_scan7(params["mega7"], state, x[:, 0], mask[:, 0],
                                        rescale if do_rescale else None, LN_EPS, GN_EPS,
                                        L2_EPS)
            return xo[:, None], new_state
        if "mega56" in params:
            xo, new_state = layer_scan56(params["mega56"], state, x[:, 0], mask[:, 0],
                                         rescale if do_rescale else None, LN_EPS, GN_EPS)
            return xo[:, None], new_state
    x = top("post_embed_layer_norm", x=x)["x"]
    x = top("post_embed", x=x)["x"]  # the legacy alias
    v0 = None
    news = []
    for i in range(L):
        lst = {key: a[i] for key, a in state.items()}
        hk = _hook_ctx(hooks, i)
        if info.version == ModelVersion.V7:
            x, v0, new = _layer_v7(info, layers[i], lst, x, v0, i, mask, lengths, hk)
        else:
            x, new = _LAYERS[info.version](info, layers[i], lst, x, mask, lengths, hk)
        if do_rescale and (i + 1) % rescale == 0:
            x = x * 0.5
        news.append(new)
    new_state = {key: torch.stack([n[key] for n in news]) for key in state}
    return top("pre_head", x=x)["x"], new_state


def forward_chunk(
    info: ModelInfo,
    params: dict,
    state: dict,
    tokens: torch.Tensor | None,  # [B, T] int
    lengths: torch.Tensor,  # [B] int valid token counts
    *,
    rescale: int | None = None,
    hooks: dict | None = None,
    input_embeds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Run one chunk through all layers.

    Returns ``(x, new_state)``: ``x`` is the final residual stream
    ``[B, T, C]`` in f32 (apply :func:`logits_head` to selected rows; x
    at a padded position is unspecified);
    ``new_state`` is a new dict, the input state is left as it was.
    ``rescale`` halves the residual every N layers, matching a model
    loaded with the same ``rescale``.

    ``hooks`` (:class:`HookCtx`) runs the per-layer loop with its taps.
    ``input_embeds`` ``[B, T, C]`` replaces the embedding lookup of
    ``tokens`` (which may then be None; the reference's ``Token::Embed``
    and vision input, ref: src/runtime/infer/mod.rs:21-56); ln0 and the
    mask still apply.
    """
    return _forward(info, params, layer_params(params, info.num_layer), state,
                    tokens, lengths, rescale, hooks, input_embeds)
