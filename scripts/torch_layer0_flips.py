#!/usr/bin/env python3
"""Where the whole-stack RWKV-7 kernel's layer 0 leaves its plain version,
on the card test's model (tests/test_torch_cuda.py::test_layer_scan7_on_card:
two layers at C = 256, Q4_K, a random state from a seeded generator, lane 1
frozen). For each B, one layer-0 launch against the plain version:

- the attention output y (the kernel's bf16 Wo input, ``staged``) against
  the plain version's f32 one, from its own first LayerNorm and given the
  kernel's: the most of |Δ| / (2^-8·|y| + 1e-4·max|y|), and how many
  elements differ from bf16 of the plain version's;
- each state's largest difference from the plain version's own, as a share
  of its max.

From the repo root, on a machine with a CUDA card:

    python3 scripts/torch_layer0_flips.py [B ...]      (default 8 9 16)
"""

import os
import sys

sys.path.insert(0, os.getcwd())


def main():
    import torch

    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import embed_tokens, load_model, prepare_decode
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7
    from web_rwkv_gguf_tpu_torch.quant import ggml
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    if not torch.cuda.is_available():
        raise SystemExit("torch_layer0_flips: needs a CUDA card")
    card = torch.device("cuda")
    eps = (LN_EPS, GN_EPS, L2_EPS)
    raw = make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       quantize=ggml.GgmlDType.Q4_K, head_quantize=ggml.GgmlDType.Q6_K, seed=6)
    info, params = load_model(GgufFile(raw), device=card)
    for B in [int(a) for a in sys.argv[1:]] or [8, 9, 16]:
        mega = prepare_decode(params, info, B)["mega7"]
        g = torch.Generator(device=card).manual_seed(B)
        L, C, H = info.num_layer, info.num_emb, info.num_head
        state = {k: torch.randn(*s, generator=g, device=card) * 0.5
                 for k, s in (("att_shift", (L, B, C)), ("wkv", (L, B, H, 64, 64)),
                              ("ffn_shift", (L, B, C)))}
        x = embed_tokens(params, torch.arange(B, device=card)[:, None] * 7 + 1)[:, 0]
        mask = torch.ones(B, device=card)
        if B >= 3:
            mask[1] = 0.0
        m_0, s_0 = layer7.mega_layers(mega, 0, 1), {k: v[:1] for k, v in state.items()}
        got, own, given = {}, {}, {}
        _, s_k, _ = layer7.layer_scan7(m_0, s_0, x, mask, None, *eps, (None, 0), staged=got)
        _, s_p, _ = layer7.layer_scan7_plain(m_0, s_0, x, mask, None, *eps, (None, 0),
                                             staged=own)
        layer7.layer_scan7_plain(m_0, s_0, x, mask, None, *eps, (None, 0),
                                 ln_out=(s_k["att_shift"], None), staged=given)
        live = mask > 0
        yk = got["y"].float()[live]
        for tag, ref in (("its own LayerNorm", own), ("the kernel's LayerNorm", given)):
            yp = ref["y"][live]
            lim = 2 ** -8 * yp.abs() + 1e-4 * yp.abs().max()
            print(f"B={B}: y against the plain version's from {tag}: most |d|/limit "
                  f"{((yk - yp).abs() / lim).max().item():.3f}, elements off bf16 of it "
                  f"{(yk != yp.bfloat16().float()).sum().item()} of {yk.numel()}", flush=True)
        for key in s_k:
            a, b = s_k[key][0], s_p[key][0]
            print(f"B={B}: {key} off the plain version's own by "
                  f"{((a - b).abs().max() / b.abs().max()).item():.3e} of its max", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
