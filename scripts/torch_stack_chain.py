#!/usr/bin/env python3
"""Where a whole-stack case of ``torch_kernel_cases.py --stacks`` leaves its
plain version, traced back through the layer's chain of roundings.

The cases are the script's own (``STACK_SEED``, its random state, the
first B lanes, every lane live at B = 16). The kernel computes each token
shift mix as one fused multiply-add, ``fma(mix, prev - x, x)``; the plain
versions round the product first, then the sum. Both are the same mix to
within one f32 rounding, and where a mix lands near a bf16 tie the two
round it to neighbouring bf16 values, which the quantized product after
it carries on. Each layer is launched alone on the plain chain's input to
it (as chip_smoke.py's check does), then held against the plain version in
four forms: the LayerNorms the plain version's own or the kernel's (its
new shift states), and the mixes rounded twice (the plain version's) or
once (an FMA, evaluated in f64 and rounded to f32).

- RWKV-6/5 (row 13, ``layer56.cu``): the FFN value's bf16 input khid
  against its replay from the kernel's staged y (``layer56.replay_staged``
  and the three other forms): the most bf16 steps an element lies from the
  kernel's, the check's share (``chip_smoke.staged_excess``), and the
  layer's x off the plain version's as a share of ``MEGA_LAYER_TOL``.
- RWKV-7 (row 4, ``layer7.cu``): the layer's WKV state, x and v_first
  given the kernel's LayerNorm outputs (chip_smoke.py's check) with the
  mixes rounded twice and once, as shares of ``MEGA_LAYER_TOL``.

From the repo root, on a machine with a CUDA card:

    python3 scripts/torch_stack_chain.py [stack[:B] ...]   (default v5-Q4_K:16 Q4_1:16)
"""

import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def mix(torch, a, m, b, fma):
    """``a + m·(b − a)`` in f32: rounded twice (the plain versions'), or
    once, as the kernels' fused multiply-add (in f64, then f32)."""
    d = b - a
    if not fma:
        return a + m * d
    return (a.double() + m.double() * d.double()).float()


def steps(torch, cs, a, b):
    """The most bf16 steps between two bf16 tensors' elements, and how many
    lie more than one step apart."""
    places = (cs.bf16_place(a) - cs.bf16_place(b)).abs()
    return int(places.max()), int((places > 1).sum())


def trace56(torch, cs, mega, state, x, mask, eps):
    from web_rwkv_gguf_tpu_torch.ops import basic as B_
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer56

    L, version, vec = mega["L"], mega["version"], mega["vecs"]
    live = mask > 0
    x_l = x
    for i in range(L):
        m_i = layer56.mega_layers(mega, i, i + 1)
        s_i = {k: v[i:i + 1] for k, v in state.items()}
        st_k, st_p = {}, {}
        x_k, s_k = layer56.layer_scan56(m_i, s_i, x_l, mask, None, *eps, i, staged=st_k)
        x_p, _ = layer56.layer_scan56_plain(m_i, s_i, x_l, mask, None, *eps, i, staged=st_p)
        rep = layer56.replay_staged(mega, i, state, x_l, mask, *eps, st_k)
        x_share = ((x_k - x_p)[live].abs().max()
                   / (cs.MEGA_LAYER_TOL * x_p[live].abs().max())).item()
        own_share = cs.staged_excess(st_k, st_p, rep, version, live)[0]["khid"]

        def mat(name, a):
            return layer56.slot_gemv_plain(mega["forms"][name], mega["mats"][name], i,
                                           a.float())

        x_mid = x_l.float() + mat("att.Wo", st_k["y"])
        xx2_own = B_.layer_norm(x_mid, mega["ln2"][0][i], mega["ln2"][1][i], eps[0])
        fsh, mk = state["ffn_shift"][i], vec["ffn_mk"][i]
        words = []
        for ln_tag, xx2 in (("own LN2", xx2_own), ("kernel's LN2", s_k["ffn_shift"][0])):
            for fma in (False, True):
                kx2 = (mix(torch, xx2, mk, fsh, fma) if version == 6
                       else mix(torch, fsh, mk, xx2, fma))
                khid = B_.squared_relu(mat("ffn.Wk", kx2)).to(torch.bfloat16)
                share = cs.staged_excess(st_k, st_p, {**rep, "khid": khid}, version,
                                         live)[0]["khid"]
                most, over = steps(torch, cs, st_k["khid"][live], khid[live])
                words.append(f"{ln_tag}, mix rounded {'once' if fma else 'twice'}: khid "
                             f"share {share:.2f}, at most {most} steps, {over} elements "
                             f"more than one")
        print(f"layer {i}: x off the plain version's by {x_share:.2f} of the limit; "
              f"the check's khid share {own_share:.2f}; " + "; ".join(words), flush=True)
        x_l = x_p


def trace7(torch, cs, mega, state, x, mask, eps):
    from web_rwkv_gguf_tpu_torch.ops import basic as B_
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7
    from web_rwkv_gguf_tpu_torch.ops.cuda.wkv7 import att_core7_plain

    L, H, vec = mega["L"], mega["H"], mega["vecs"]
    offs = [0]
    for d in mega["lora_dims"]:
        offs.append(offs[-1] + d)
    keep = mask.bool()[:, None]
    x_l, v_first = x, None
    for i in range(L):
        m_i = layer7.mega_layers(mega, i, i + 1)
        s_i = {k: v[i:i + 1] for k, v in state.items()}
        x_k, s_k, vf_k = layer7.layer_scan7(m_i, s_i, x_l, mask, None, *eps, (v_first, i))
        x_p, s_p, vf_p = layer7.layer_scan7_plain(m_i, s_i, x_l, mask, None, *eps,
                                                  (v_first, i))

        def mat(name, a):
            return layer7.slot_gemv_plain(mega["forms"][name], mega["mats"][name], i, a)

        down, up = mega["down"][i].float(), mega["up"][i].float()

        def lora(a, j, act=None):
            return layer7.lora_plain(a, down[offs[j]:offs[j + 1]], up[:, offs[j]:offs[j + 1]],
                                     act)

        def given(fma):
            """The layer given the kernel's LayerNorm outputs, its mixes
            rounded once (``fma``) or twice."""
            xx = torch.where(keep, s_k["att_shift"][0], B_.layer_norm(
                x_l, mega["ln1"][0][i], mega["ln1"][1][i], eps[0]))
            sh = state["att_shift"][i]
            rx, wx, kx, vx, ax, gx = mix(torch, xx[:, None], mega["x_stack"][i][None],
                                         sh[:, None], fma).unbind(1)
            r, k, v = mat("att.Wr", rx), mat("att.Wk", kx), mat("att.Wv", vx)
            w_in = vec["w0"][i] + lora(wx, 0, torch.tanh)
            a_in = vec["a0"][i] + lora(ax, 1)
            g = lora(gx, 2, torch.sigmoid)
            vf = v if i == 0 else v_first
            if i:
                v = v + torch.sigmoid(vec["v0"][i] + lora(vx, 3)) * (v_first - v)
            hd = lambda t: t.reshape(t.shape[0], H, -1)  # noqa: E731
            y, wkv = att_core7_plain(
                state["wkv"][i], hd(r), hd(w_in), hd(k), hd(v), hd(a_in), hd(g),
                vec["k_k"][i].reshape(H, -1), vec["k_a"][i].reshape(H, -1),
                mega["gn"][0][i].reshape(H, -1), mega["gn"][1][i].reshape(H, -1),
                mega["r_k"][i], mask, eps[1], eps[2])
            xo = x_l + mat("att.Wo", y.reshape(y.shape[0], -1))
            xx2 = torch.where(keep, s_k["ffn_shift"][0], B_.layer_norm(
                xo, mega["ln2"][0][i], mega["ln2"][1][i], eps[0]))
            kx2 = mix(torch, xx2, vec["ffn_xk"][i], state["ffn_shift"][i], fma)
            xo = xo + mat("ffn.Wv", B_.squared_relu(mat("ffn.Wk", kx2)))
            return {"x": xo, "wkv": wkv, "v_first": vf}

        got = {"x": x_k, "wkv": s_k["wkv"][0], "v_first": vf_k}
        words = []
        for fma in (False, True):
            ref = given(fma)
            share = {k: ((got[k] - ref[k]).abs().max()
                         / (cs.MEGA_LAYER_TOL * ref[k].abs().max())).item()
                     for k in ("x", "wkv", "v_first")}
            shares = ", ".join(f"{k} {v:.2f}" for k, v in share.items())
            words.append(f"mixes rounded {'once' if fma else 'twice'}: {shares}")
        print(f"layer {i}, given the kernel's LayerNorms, shares of the limit: "
              + "; ".join(words), flush=True)
        x_l, v_first = x_p, vf_p


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    import torch_kernel_cases as kc
    from web_rwkv_gguf_tpu_torch import models
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.quant import QuantScheme

    if not torch.cuda.is_available():
        raise SystemExit("torch_stack_chain: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for arg in sys.argv[1:] or ["v5-Q4_K:16", "Q4_1:16"]:
        form, _, b = arg.partition(":")
        cases.append((form, int(b or 16)))
    stack_dir = os.path.join("web_rwkv_gguf_tpu_torch", "ops", "cuda", "_build", "stacks")
    os.makedirs(stack_dir, exist_ok=True)
    for form, B in cases:
        with open(kc.build_stack_file(stack_dir, form), "rb") as f:
            raw = f.read()
        v7 = form not in kc.STACKS56
        quant = kc.STACK_FORMS[form][1] if v7 else kc.STACKS56[form][2]
        info, params = models.load_model(
            GgufFile(raw), quant=QuantScheme[quant] if quant else None, device="cuda")
        mega = models.prepare_decode(params, info, 4)["mega7" if v7 else "mega56"]
        L, C, H = info.num_layer, info.num_emb, info.num_head
        # torch_kernel_cases.stack_cases's random state and input, its first B lanes
        rng = np.random.default_rng(kc.STACK_SEED)
        f = lambda *s: torch.from_numpy(  # noqa: E731
            (rng.standard_normal(s) * 0.5).astype(np.float32)).cuda()
        state = {"att_shift": f(L, kc.STACK_LANES, C), "ffn_shift": f(L, kc.STACK_LANES, C)}
        if v7 or mega["version"] != 4:
            state["wkv"] = f(L, kc.STACK_LANES, H, 64, 64)
        else:
            state.update(aa=f(L, kc.STACK_LANES, C), bb=f(L, kc.STACK_LANES, C).abs() + 0.1,
                         pp=f(L, kc.STACK_LANES, C))
        toks = torch.arange(kc.STACK_LANES, device="cuda")[:, None] * 7 + 1
        x = models.embed_tokens(params, toks)[:B, 0].contiguous()
        state = {k: v[:, :B].contiguous() for k, v in state.items()}
        mask = (torch.tensor([1.0, 1.0, 0.0, 1.0], device="cuda") if B == 4
                else torch.ones(B, device="cuda"))
        print(f"==== stack {form}, B={B}", flush=True)
        if v7:
            trace7(torch, cs, mega, state, x, mask, (LN_EPS, GN_EPS, L2_EPS))
        else:
            trace56(torch, cs, mega, state, x, mask, (LN_EPS, GN_EPS))
        del params, mega
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
