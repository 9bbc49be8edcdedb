"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Imports nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX). Without a card every
test here skips. Tolerances: the gemvs sum the same f32 terms in another
order, atol = 1e-4·max|y| (the grouped r/k/v gemv too: the same f32
group sums in another order); the attention core, atol = 1e-4; the
dequant-GEMMs multiply the same bf16 weights in another order, atol =
1e-4·max|y|; the WKV scans (V7, V6 and V4), atol = 1e-4·max|plain| on y and
the state; the whole-stack decode kernels as their tests say.
"""

import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm
from web_rwkv_gguf_tpu_torch.ops.cuda import wkv7 as core
from web_rwkv_gguf_tpu_torch.quant import ggml, repack


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _weights(m, k, quantize, seed):
    w = (np.random.default_rng(seed).normal(size=(m, k)) * 0.05).astype(np.float32)
    return np.frombuffer(quantize(w.reshape(-1)), np.uint8)


def _x(n, k, seed, dev):
    x = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def _close(got, want, rel):
    torch.testing.assert_close(got, want, rtol=0, atol=rel * want.abs().max().item())


# Q4_K gemv shapes: every n at the 0.1B layer width and at K=3072, ragged M
# (17, 1000), the V6 FFN value at n = 1 and K=7168 at n = 8 (the largest x)
Q4K_GEMV_CASES = ([(768, 768, n) for n in range(1, 9)] + [(256, 3072, n) for n in range(1, 9)]
                  + [(17, 768, 1), (17, 768, 5), (1000, 1024, 3), (1000, 1024, 8),
                     (2048, 7168, 1), (64, 7168, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", Q4K_GEMV_CASES)
def test_q4k_gemv_on_card(card, m, k, n):
    arrays = _q4k_arrays(m, k, m + k, card)
    x = _x(n, k, n, card)
    before = mm.q4k_gemv.launches
    got = mm.q4k_gemv(x, *arrays)
    assert mm.q4k_gemv.launches == before + 1
    _close(got, mm.q4k_gemv_plain(x, *arrays), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(2048, 7168), (768, 3072)])
def test_q4k_gemv_on_same_signed_inputs_on_card(card, m, k):
    """``q4k_gemv`` at n = 1 on inputs that are all ≥ 0 (relu², the FFN
    value's input; the V6 and V7 value matrices of the B=1 serve): the
    offset term ``mn·Σx`` cancels most of ``s·Σq·x`` in every group."""
    arrays = _q4k_arrays(m, k, m + k, card)
    x = torch.relu(_x(1, k, 5, card)) ** 2
    _close(mm.q4k_gemv(x, *arrays), mm.q4k_gemv_plain(x, *arrays), 1e-4)


# Q6_K / Q3_K gemv shapes (GGML-quantized, native factors): every n at
# [1024, 768], Q3_K's code ranges, ragged M, K=7168 at n = 8, and the 0.1B
# head at n = 4
Q6K_GEMV_CASES = ([("Q6_K", 1024, 768, n) for n in range(1, 9)]
                  + [("Q3_K", 1024, 768, n) for n in (1, 4, 8)]
                  + [("Q6_K", 17, 256, 2), ("Q3_K", 17, 512, 7), ("Q6_K", 1000, 1024, 6),
                     ("Q6_K", 64, 7168, 8), ("Q6_K", 65536, 768, 4)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,k,n", Q6K_GEMV_CASES)
def test_q6k_gemv_on_card(card, kind, m, k, n):
    a = _matrix(kind, m, k, n, card).arrays
    arrays = [a["codes"], a["q6s"], a["q6d"]]
    x = _x(n, k, n + 1, card)
    before = mm.q6k_gemv.launches
    got = mm.q6k_gemv(x, *arrays)
    assert mm.q6k_gemv.launches == before + 1
    _close(got, mm.q6k_gemv_plain(x, *arrays), 1e-4)


@pytest.mark.cuda
def test_gemv_refuses_what_the_kernel_does_not_take(card):
    m, k = 256, 512
    raw = _weights(m, k, ggml.quantize_q4_k, seed=0)
    arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
              for a in (repack.repack_q4_k(raw, m, k)[0], *repack.q4k_scale_factors(raw, m, k))]
    with pytest.raises(ValueError):
        mm.q4k_gemv(_x(9, k, 0, card), *arrays)  # n > 8
    with pytest.raises(ValueError):
        mm.q4k_gemv(_x(1, k, 0, card), arrays[0], arrays[1].t().contiguous().t(),
                    *arrays[2:])  # a non-contiguous factor array
    with pytest.raises(ValueError):
        mm.q4k_gemv(_x(1, 256, 0, card), *arrays)  # wrong K


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 4, 16])
def test_att_core7_on_card(card, B):
    """At H=12: the B=1 serve, B=3 with lane 1 masked, the Engine's B=4,
    and B=16 with lanes 1, 5 and 11 masked; a masked lane keeps its state
    bit for bit, and each call is one launch."""
    H, K = 12, 64
    g = torch.Generator(device=card).manual_seed(B)
    f = lambda *s: torch.randn(*s, generator=g, device=card) * 0.5  # noqa: E731
    mask = torch.ones(B, dtype=torch.bool, device=card)
    mask[{3: [1], 16: [1, 5, 11]}.get(B, [])] = False
    args = (f(B, H, K, K), f(B, H, K), f(B, H, K), f(B, H, K), f(B, H, K), f(B, H, K),
            torch.sigmoid(f(B, H, K)), f(H, K), f(H, K), 1 + 0.1 * f(H, K),
            0.1 * f(H, K), f(H, K), mask, 64e-5, 1e-12)
    before = core.att_core7_step.launches
    y1, s1 = core.att_core7_step(*args)
    assert core.att_core7_step.launches == before + 1
    y0, s0 = core.att_core7_plain(*args)
    torch.testing.assert_close(s1, s0, rtol=0, atol=1e-4)
    torch.testing.assert_close(y1[mask], y0[mask], rtol=0, atol=1e-4)
    assert torch.equal(s1[~mask], args[0][~mask])  # masked lanes keep their state


def _q4k_arrays(m, k, seed, dev):
    raw = _weights(m, k, ggml.quantize_q4_k, seed)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (repack.repack_q4_k(raw, m, k)[0], *repack.q4k_scale_factors(raw, m, k))]


def _q6k_arrays(m, k, seed, dev):
    raw = _weights(m, k, ggml.quantize_q6_k, seed)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (repack.repack_q6_k(raw, m, k)[0], *repack.q6k_scale_factors(raw, m, k))]


# row counts at the dequant-GEMM's tile edges (16, 64 and 2 x 128 input rows)
GEMM_ROWS = [9, 63, 64, 65, 255, 256, 257, 512, 513]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 130, *GEMM_ROWS])
@pytest.mark.parametrize("m,k", [(768, 3072), (100, 512), (200, 1280), (832, 7168)])
def test_q4k_gemm_on_card(card, m, k, n):
    """Including ragged M (100, 200 rows: not a multiple of the 64-row
    tile) and n at and around every tile edge."""
    arrays = _q4k_arrays(m, k, m + k + n, card)
    x = _x(n, k, n, card)
    before = mm.q4k_gemm.launches
    got = mm.q4k_gemm(x, *arrays)
    assert mm.q4k_gemm.launches == before + 1
    _close(got, mm.q4k_gemm_plain(x, *arrays), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1000, 768, 6), (1000, 768, 64), (200, 768, 257),
                                   (65536, 2048, 4), (65536, 2048, 64)])
def test_q6k_gemm_on_card(card, m, k, n):
    """Layer shapes and the vocabulary head at the Engine's n = 4 and a FULL
    infer's 64 (M = 65536: 1,024 tiles, the narrow tiles of 16 and 64 input
    rows)."""
    arrays = _q6k_arrays(m, k, n, card)
    x = _x(n, k, n + 2, card)
    before = mm.q6k_gemm.launches
    got = mm.q6k_gemm(x, *arrays)
    assert mm.q6k_gemm.launches == before + 1
    _close(got, mm.q6k_gemm_plain(x, *arrays), 1e-4)


def _wkv_args(B, T, lens, dev, seed=0, H=12):
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.5  # noqa: E731
    K = 64
    kk = torch.nn.functional.normalize(f(B, T, H, K), dim=-1)
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    return (f(B, H, K, K), f(B, T, H, K), torch.exp(-0.606531 * torch.sigmoid(f(B, T, H, K))),
            f(B, T, H, K), f(B, T, H, K), -kk, kk * torch.sigmoid(f(B, T, H, K)), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [(1,), (1, 0, 1), (2,), (37, 20, 0)])
def test_wkv7_scan_on_card(card, lens):
    """The V7 WKV scan against its plain version; T = 1 is the hooked
    decode step's (forward_chunk with hooks leaves the fused att-core
    kernel), a lane of length 0 keeps its state."""
    args = _wkv_args(len(lens), max(lens), lens, card)
    before = core.wkv7_scan.launches
    y1, s1 = core.wkv7_scan(*args)
    assert core.wkv7_scan.launches == before + 1
    y0, s0 = core.wkv7_scan_plain(*args)
    _close(y1, y0, 1e-4)
    _close(s1, s0, 1e-4)
    if 0 in lens:
        assert torch.equal(s1[lens.index(0)], args[0][lens.index(0)])


# the scans' shapes: T = 1 (V6/V5 decode), 8 (the B=1 serve's prompt
# chunks), 64 (an Engine chunk) and 127 (the longest scan chunk); B = 1, 4,
# 16; H = 12 (V7 0.1B), 16 (V5 0.4B), 32 (V6 1.6B)
SCAN_SHAPES = [(B, T, H) for B in (1, 4, 16) for T in (1, 8, 64, 127) for H in (12, 16, 32)]


def _scan_lens(B, T):
    """Ragged lengths: lane 0 whole, the others shorter, the last one
    empty from B=4 on."""
    lens = [max(0, T - (13 * b) % (T + 1)) for b in range(B)]
    if B >= 4:
        lens[-1] = 0
    return tuple(lens)


def _scan_check(kernel, plain, args, y_at=None):
    """One launch of ``kernel``, held against ``plain`` at 1e-4·max|plain|
    on y (at every position, or where ``y_at`` is set) and the state."""
    before = kernel.launches
    y1, s1 = kernel(*args)
    assert kernel.launches == before + 1
    y0, s0 = plain(*args)
    if y_at is None:
        _close(y1, y0, 1e-4)
    else:
        _close(y1[y_at], y0[y_at], 1e-4)
    _close(s1, s0, 1e-4)
    return y1, s1


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", SCAN_SHAPES)
def test_wkv7_scan_shapes_on_card(card, B, T, H):
    """The V7 scan at every shape of SCAN_SHAPES, ragged lanes; an empty
    lane keeps its state bit for bit."""
    lens = _scan_lens(B, T)
    args = _wkv_args(B, T, lens, card, seed=B * 1000 + T * 10 + H, H=H)
    _, s1 = _scan_check(core.wkv7_scan, core.wkv7_scan_plain, args)
    for b in (b for b, n in enumerate(lens) if n == 0):
        assert torch.equal(s1[b], args[0][b])


@pytest.mark.cuda
def test_wkv7_scan_mask_with_holes_on_card(card):
    """Padded tokens between live ones (not a prefix mask): each leaves
    the state as it was, y read from it."""
    B, T = 3, 40
    args = list(_wkv_args(B, T, (T,) * B, card, seed=5))
    g = torch.Generator(device=card).manual_seed(6)
    args[-1] = torch.rand(B, T, generator=g, device=card) < 0.6
    args[-1][2] = False  # a lane with no live token
    _, s1 = _scan_check(core.wkv7_scan, core.wkv7_scan_plain, args)
    assert torch.equal(s1[2], args[0][2])


@pytest.mark.cuda
def test_wkv7_scan_padding_leaves_the_state_exactly_on_card(card):
    """A lane of 37 tokens at T=64 (27 padded) and at T=37 ends in the same
    state, bit for bit: the kernel's split does not depend on T, and a
    padded token changes nothing."""
    args = _wkv_args(1, 64, (37,), card, seed=7)
    short = [a[:, :37] if a.dim() == 4 and a.shape[1] == 64 else a for a in args[:-1]]
    _, s64 = core.wkv7_scan(*args)
    _, s37 = core.wkv7_scan(*short, args[-1][:, :37])
    assert torch.equal(s64, s37)


@pytest.mark.cuda
def test_forward_refuses_what_this_slice_does_not_run_on_the_card(card):
    """A Q4_K matrix without whole 256-element super-blocks per row, which
    earlier slices refused on the card, now runs there through the
    f32-scale kernels (``qs_gemv`` at decode, ``qs_gemm`` at prefill) and
    matches the CPU at chip_smoke.py's card-vs-CPU limit (1e-2·max)."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import forward_chunk, init_state, load_model
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=1, n_emb=256, head_size=64, n_vocab=64, n_hidden=384,
                       quantize=ggml.GgmlDType.Q4_K, seed=3)
    # ffn.value is [256, 384]: the gemv at T=1, the GEMM at T=32 (n·groups = 384)
    for toks, kernel in (([[1]], mm.qs_gemv), ([list(range(1, 33))], mm.qs_gemm)):
        out = []
        for dev in ("cpu", card):
            info, params = load_model(GgufFile(raw), device=dev)
            before = kernel.launches
            x, _ = forward_chunk(info, params, init_state(info, 1, device=dev),
                                 torch.tensor(toks, device=dev),
                                 torch.tensor([len(toks[0])], device=dev))
            out.append((kernel.launches - before, x.cpu()))
        assert out[0][0] == 0 and out[1][0] == 1
        _close(out[1][1], out[0][1], 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [5, 128])
def test_prefill_routes_through_the_kernels_on_card(card, T):
    """A prefill chunk on the card: every quantized matmul runs the
    dequant-GEMM, the WKV the scan kernel below T=128 and the
    chunk-parallel form from it; logits and state match the CPU within
    the card-vs-CPU tolerance of chip_smoke.py (1e-2·max|CPU|)."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import forward_chunk, init_state, load_model, logits_head
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       quantize=ggml.GgmlDType.Q4_K, head_quantize=ggml.GgmlDType.Q6_K,
                       seed=4)
    toks = torch.from_numpy(np.random.default_rng(T).integers(0, 512, (2, T)))
    lens = torch.tensor([T, T - 3])
    out = {}
    for dev in ("cpu", card):
        info, params = load_model(GgufFile(raw), device=dev)
        counts = (mm.q4k_gemm.launches, core.wkv7_scan.launches)
        x, st = forward_chunk(info, params, init_state(info, 2, device=dev),
                              toks.to(dev), lens.to(dev))
        launched = (mm.q4k_gemm.launches - counts[0], core.wkv7_scan.launches - counts[1])
        logits = logits_head(params, x[torch.arange(2), lens.to(dev) - 1])
        out[str(dev)] = (launched, logits.cpu(), {k: v.cpu() for k, v in st.items()})
    (l_cpu, lg_cpu, st_cpu), (l_gpu, lg_gpu, st_gpu) = out["cpu"], out[str(card)]
    assert l_cpu == (0, 0)
    assert l_gpu == (6 * 2, 2 if T < 128 else 0)
    _close(lg_gpu, lg_cpu, 1e-2)
    for key in st_cpu:
        _close(st_gpu[key], st_cpu[key], 1e-2)


# lanes of the RWKV-7 whole-stack card tests: every NB template of
# layer7.cu (1, 2, 4, 8, 16), full and ragged (3, 9)
LAYER7_BATCHES = [1, 2, 3, 8, 9, 16]
# every slot form an RWKV-7 stack takes (layer7.stack_matrix)
LAYER7_FORMS = ["Q4_K", "Q5_K", "Q2_K", "Q8_0", "Q6_K", "Q3_K", "Q4_1", "INT8", "BF16"]
# lanes at which the plain version's own f32 order of the first LayerNorm
# flips bf16 roundings of layer 0's mixes and moves these layer-0 states
# past 1e-4 of their max from the kernel's (8 and 16 for the
# one-warp-a-row kernel before this one's redesign as well; 9 through 7
# elements of Wo's input, which given the kernel's LayerNorm output are
# bf16 of the plain version's every one; PERF.md)
LAYER7_FLIP_BATCHES = {8: ("wkv", "ffn_shift"), 9: ("ffn_shift",), 16: ("wkv", "ffn_shift")}


@pytest.mark.cuda
@pytest.mark.parametrize("B", LAYER7_BATCHES)
def test_layer_scan7_on_card(card, B):
    """The whole-stack decode kernel against its plain version on a
    two-layer model from a random state, one lane frozen at B ≥ 3: layer
    0's states at 1e-4·max (f32 sums in another order), every output at
    1e-2·max (the bf16 operand flips that layer 0 passes on, as in
    chip_smoke.py); the frozen lane's state is kept exactly. At the B of
    LAYER7_FLIP_BATCHES, the states it names are held at the same
    1e-4·max against the plain version given the kernel's first LayerNorm
    output (``ln_out``, as chip_smoke.py holds row 4) and its attention
    output (``y_in``, from a one-layer launch of layer 0, whose states
    equal the whole launch's); that attention output is held itself, each
    element against the plain version's f32 one (given the same LayerNorm
    output) within its bf16 rounding, 2^-8 of it, and 1e-4·max."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import embed_tokens, load_model, prepare_decode
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       quantize=ggml.GgmlDType.Q4_K, head_quantize=ggml.GgmlDType.Q6_K,
                       seed=6)
    info, params = load_model(GgufFile(raw), device=card)
    mega = prepare_decode(params, info, B)["mega7"]
    g = torch.Generator(device=card).manual_seed(B)
    f = lambda *s: torch.randn(*s, generator=g, device=card) * 0.5  # noqa: E731
    L, C, H = info.num_layer, info.num_emb, info.num_head
    state = {"att_shift": f(L, B, C), "wkv": f(L, B, H, 64, 64), "ffn_shift": f(L, B, C)}
    x = embed_tokens(params, torch.arange(B, device=card)[:, None] * 7 + 1)[:, 0]
    mask = torch.ones(B, device=card)
    if B >= 3:
        mask[1] = 0.0
    before = layer7.layer_scan7.launches
    x1, s1 = layer7.layer_scan7(mega, state, x, mask, None, LN_EPS, GN_EPS, L2_EPS)
    assert layer7.layer_scan7.launches == before + 1
    x0, s0 = layer7.layer_scan7_plain(mega, state, x, mask, None, LN_EPS, GN_EPS, L2_EPS)
    want0 = {key: s0[key][0] for key in s0}
    if B in LAYER7_FLIP_BATCHES:
        m_0, s_0 = layer7.mega_layers(mega, 0, 1), {k: v[:1] for k, v in state.items()}
        eps, ln1 = (LN_EPS, GN_EPS, L2_EPS), (s1["att_shift"][:1], None)
        staged, staged_p = {}, {}
        _, s10, _ = layer7.layer_scan7(m_0, s_0, x, mask, None, *eps, (None, 0), staged=staged)
        for key in s0:
            assert torch.equal(s10[key][0], s1[key][0])
        layer7.layer_scan7_plain(m_0, s_0, x, mask, None, *eps, (None, 0), ln_out=ln1,
                                 staged=staged_p)
        live = mask > 0
        yk, yp = staged["y"].float()[live], staged_p["y"][live]
        assert ((yk - yp).abs() <= 2 ** -8 * yp.abs() + 1e-4 * yp.abs().max()).all()
        _, sg, _ = layer7.layer_scan7_plain(m_0, s_0, x, mask, None, *eps, (None, 0),
                                            ln_out=ln1, y_in=staged["y"][None])
        want0.update({key: sg[key][0] for key in LAYER7_FLIP_BATCHES[B]})
    for key in s0:
        _close(s1[key][0], want0[key], 1e-4)
        _close(s1[key], s0[key], 1e-2)
        if B >= 3:
            assert torch.equal(s1[key][:, 1], state[key][:, 1])
    _close(x1, x0, 1e-2)


@pytest.mark.cuda
def test_layer_scan7_q4_1_stack_at_seed_120_b16_on_card(card, tmp_path):
    """The case of ``scripts/torch_kernel_cases.py --stacks Q4_1 --batches
    16`` (the 0.1B widths at full depth in Q4_1 nibbles, ``STACK_SEED`` =
    120, its random state, 16 live lanes) through that script's own
    check (chip_smoke.py's ``mega_case``: every layer of the whole-stack
    kernel against the plain version given the kernel's LayerNorm outputs,
    at 2^-8·max). It failed at layers 1 and 11 (the WKV state 1.41 and
    1.57 of the limit) while layer7.cu fused each token-shift mix into one
    multiply-add; the mixes now round as the plain version rounds them."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in (root, os.path.join(root, "scripts")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import chip_smoke as cs
    import torch_kernel_cases as kc

    kc.build_stack_file(str(tmp_path), "Q4_1")
    _, bf16_peak, f32_peak = cs.peaks(torch.cuda.get_device_name(0))
    (case,) = kc.stack_cases(torch, str(tmp_path), ["Q4_1"], [16], bf16_peak, f32_peak)
    err, limit = case["check"](case["make_args"](0))
    assert err <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("prepared", ["whole_stack", "unrolled"])
def test_hooked_v7_decode_step_launches_on_card(card, prepared):
    """A T=1 step of a two-layer RWKV-7 Q4_K model on the Engine's decode
    params (``prepare_decode``: the whole-stack block; ``unroll_params`` at
    one lane: the grouped r/k/v gemv). ``hooks={}`` leaves the whole-stack
    kernel only; a non-empty ``hooks`` also leaves the fused att-core kernel
    and the grouped gemv, and its WKV runs as ``wkv7_scan`` at T=1, one
    launch a layer. Every tap fires at both layers, and the hooked step's
    logits and state match the unhooked step's at the card's 1e-2·max."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import (
        forward_chunk, init_state, load_model, logits_head, prepare_decode, unroll_params,
    )
    from web_rwkv_gguf_tpu_torch.models.forward import HOOK_NAMES
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       quantize=ggml.GgmlDType.Q4_K, head_quantize=ggml.GgmlDType.Q6_K,
                       seed=4)
    info, params = load_model(GgufFile(raw), device=card)
    B = 1
    params = prepare_decode(params, info, B) if prepared == "whole_stack" else unroll_params(params)
    tok = torch.tensor([[5]], device=card)
    lens = torch.ones(B, dtype=torch.long, device=card)
    fired = []
    taps = {n: (lambda name: lambda layer, **t: fired.append((name, layer)))(n)
            for n in HOOK_NAMES[info.version]}
    counters = (layer7.layer_scan7, core.att_core7_step, mm.quant_gemv_grouped, core.wkv7_scan)
    out = {}
    for tag, hooks in (("none", None), ("empty", {}), ("taps", taps)):
        before = [c.launches for c in counters]
        x, st = forward_chunk(info, params, init_state(info, B, device=card), tok, lens,
                              hooks=hooks)
        out[tag] = (logits_head(params, x[:, 0], hooks=hooks), st,
                    [c.launches - b for c, b in zip(counters, before)])
    stacked = prepared == "whole_stack"
    assert out["none"][2] == ([1, 0, 0, 0] if stacked else [0, 2, 2, 0])
    assert out["empty"][2] == ([0, 2, 0, 0] if stacked else [0, 2, 2, 0])
    assert out["taps"][2] == [0, 0, 0, 2]
    model_level = {"post_embed_loaded", "post_embed_layer_norm", "pre_head",
                   "post_head_layer_norm", "post_head"}
    for name in HOOK_NAMES[info.version]:
        want = [-1] if name in model_level else [0, 1]
        assert [layer for n, layer in fired if n == name] == want, name
    _close(out["taps"][0], out["none"][0], 1e-2)
    for key in out["none"][1]:
        _close(out["taps"][1][key], out["none"][1][key], 1e-2)


def _wkv6_args(B, T, lens, dev, seed=0, H=12, static_w=False):
    """The V6 scan's inputs; ``static_w``: V5's decay, one [H, K] tensor
    ``expand``ed over lanes and tokens as ``forward._wkv5`` passes it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.5  # noqa: E731
    K = 64
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    w = (torch.exp(-torch.exp(f(H, K))).expand(B, T, H, K) if static_w
         else torch.exp(-torch.exp(f(B, T, H, K))))
    return (f(B, H, K, K), f(B, T, H, K), f(B, T, H, K), f(B, T, H, K), f(H, K), w, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [(1, 0, 1), (2,), (37, 20, 0)])
def test_wkv6_scan_on_card(card, lens):
    """The V6 WKV scan against its plain version, atol = 1e-4·max|plain|
    on y (live positions) and the state; a lane of length 0 keeps its
    state exactly."""
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv6

    args = _wkv6_args(len(lens), max(lens), lens, card)
    before = wkv6.wkv6_scan.launches
    y1, s1 = wkv6.wkv6_scan(*args)
    assert wkv6.wkv6_scan.launches == before + 1
    y0, s0 = wkv6.wkv6_scan_plain(*args)
    mask = args[-1]
    _close(y1[mask], y0[mask], 1e-4)
    _close(s1, s0, 1e-4)
    if 0 in lens:
        assert torch.equal(s1[lens.index(0)], args[0][lens.index(0)])


@pytest.mark.cuda
@pytest.mark.parametrize("static_w", [False, True], ids=["v6", "v5_static_w"])
@pytest.mark.parametrize("B,T,H", SCAN_SHAPES)
def test_wkv6_scan_shapes_on_card(card, B, T, H, static_w):
    """The V6 scan at every shape of SCAN_SHAPES, ragged lanes, y at every
    position; with V5's static decay as the expanded view, which the kernel
    reads in place. An empty lane keeps its state bit for bit."""
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv6

    lens = _scan_lens(B, T)
    args = _wkv6_args(B, T, lens, card, seed=B * 1000 + T * 10 + H, H=H, static_w=static_w)
    if static_w:  # read in place, never widened to [B, T, H, 64]
        got, static = wkv6.decay_operand(args[5])
        assert static and got.data_ptr() == args[5].data_ptr()
    _, s1 = _scan_check(wkv6.wkv6_scan, wkv6.wkv6_scan_plain, args)
    for b in (b for b, n in enumerate(lens) if n == 0):
        assert torch.equal(s1[b], args[0][b])


@pytest.mark.cuda
@pytest.mark.parametrize("static_w", [False, True], ids=["v6", "v5_static_w"])
def test_wkv6_scan_mask_with_holes_on_card(card, static_w):
    """Padded tokens between live ones (not a prefix mask)."""
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv6

    B, T = 3, 40
    args = list(_wkv6_args(B, T, (T,) * B, card, seed=5, H=32, static_w=static_w))
    g = torch.Generator(device=card).manual_seed(6)
    args[-1] = torch.rand(B, T, generator=g, device=card) < 0.6
    args[-1][2] = False  # a lane with no live token
    _, s1 = _scan_check(wkv6.wkv6_scan, wkv6.wkv6_scan_plain, args)
    assert torch.equal(s1[2], args[0][2])


@pytest.mark.cuda
@pytest.mark.parametrize("static_w", [False, True], ids=["v6", "v5_static_w"])
def test_wkv6_scan_padding_leaves_the_state_exactly_on_card(card, static_w):
    """A lane of 37 tokens at T=64 and at T=37 ends in the same state, bit
    for bit."""
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv6

    args = _wkv6_args(1, 64, (37,), card, seed=7, H=32, static_w=static_w)
    short = [a[:, :37] if a.dim() == 4 and a.shape[1] == 64 else a for a in args[:-1]]
    _, s64 = wkv6.wkv6_scan(*args)
    _, s37 = wkv6.wkv6_scan(*short, args[-1][:, :37])
    assert torch.equal(s64, s37)


def _v6_model(card, seed=6):
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import load_model
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf

    raw = make_v6_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       rank_tm=32, rank_td=64, quantize=ggml.GgmlDType.Q4_K,
                       head_quantize=ggml.GgmlDType.Q6_K, seed=seed)
    return raw, load_model(GgufFile(raw), device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("B", LAYER7_BATCHES)
def test_layer_scan56_on_card(card, B):
    """The whole-stack V6 decode kernel against its plain version on a
    two-layer model (ranks 32/64) from a random state, one lane frozen at
    B ≥ 3: each layer as a one-layer slice on the plain chain's input,
    every output at 2^-8·max of that layer (one bf16 step: the f32 sums
    in another order flip a few bf16 operand roundings, as chip_smoke.py
    holds it); the frozen lane's state is kept exactly."""
    from web_rwkv_gguf_tpu_torch.models import embed_tokens, prepare_decode
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer56

    _, (info, params) = _v6_model(card)
    mega = prepare_decode(params, info, B)["mega56"]
    g = torch.Generator(device=card).manual_seed(B)
    f = lambda *s: torch.randn(*s, generator=g, device=card) * 0.5  # noqa: E731
    L, C, H = info.num_layer, info.num_emb, info.num_head
    state = {"att_shift": f(L, B, C), "wkv": f(L, B, H, 64, 64), "ffn_shift": f(L, B, C)}
    x = embed_tokens(params, torch.arange(B, device=card)[:, None] * 7 + 1)[:, 0]
    mask = torch.ones(B, device=card)
    if B >= 3:
        mask[1] = 0.0
    before = layer56.layer_scan56.launches
    for i in range(L):
        m_i = layer56.mega_layers(mega, i, i + 1)
        s_i = {k: v[i:i + 1] for k, v in state.items()}
        x1, s1 = layer56.layer_scan56(m_i, s_i, x, mask, None, LN_EPS, GN_EPS, first_layer=i)
        x0, s0 = layer56.layer_scan56_plain(m_i, s_i, x, mask, None, LN_EPS, GN_EPS, i)
        live = mask > 0
        _close(x1[live], x0[live], 2.0 ** -8)
        for key in s0:
            _close(s1[key], s0[key], 2.0 ** -8)
            if B >= 3:
                assert torch.equal(s1[key][:, 1], s_i[key][:, 1])
        x = x0
    assert layer56.layer_scan56.launches == before + L


@pytest.mark.cuda
def test_v6_kernels_refuse_what_they_do_not_take(card):
    from web_rwkv_gguf_tpu_torch.models import prepare_decode
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer56, wkv6

    args = list(_wkv6_args(1, 4, (4,), card))
    with pytest.raises(ValueError):  # head size 32
        wkv6.wkv6_scan(args[0][..., :32, :32].contiguous(),
                       *(a[..., :32].contiguous() for a in args[1:6]), args[6])
    with pytest.raises(ValueError):  # u of the wrong shape
        wkv6.wkv6_scan(*args[:4], args[4][:6], *args[5:])
    _, (info, params) = _v6_model(card)
    mega = prepare_decode(params, info, 1)["mega56"]
    L, C, H = info.num_layer, info.num_emb, info.num_head
    z = lambda *s: torch.zeros(*s, device=card)  # noqa: E731
    state = {"att_shift": z(L, 17, C), "wkv": z(L, 17, H, 64, 64), "ffn_shift": z(L, 17, C)}
    with pytest.raises(ValueError):  # 17 lanes
        layer56.layer_scan56(mega, state, z(17, C), z(17), None, 1e-5, 64e-5)
    bad = {**mega, "tm_w2": mega["tm_w2"].transpose(-1, -2)}  # not contiguous
    state1 = {k: v[:, :1] for k, v in state.items()}
    with pytest.raises(ValueError):
        layer56.layer_scan56(bad, state1, z(1, C), z(1), None, 1e-5, 64e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5, 128])
def test_v6_forward_routes_through_the_kernels_on_card(card, T):
    """A V6 chunk on the card through the per-layer path: the quantized
    matmuls on the Q4_K kernels (8 per layer), the WKV on the scan kernel
    below T=128 (at T=1 too) and on the chunk-parallel form from it;
    logits and state match the CPU within chip_smoke.py's card-vs-CPU
    tolerance (1e-2·max|CPU|)."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import forward_chunk, init_state, load_model, logits_head
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv6

    raw, _ = _v6_model(card, seed=4)
    toks = torch.from_numpy(np.random.default_rng(T).integers(0, 512, (2, T)))
    lens = torch.tensor([T, max(T - 3, 1)])
    out = {}
    for dev in ("cpu", card):
        info, params = load_model(GgufFile(raw), device=dev)
        counts = (mm.q4k_gemv.launches + mm.q4k_gemm.launches, wkv6.wkv6_scan.launches)
        x, st = forward_chunk(info, params, init_state(info, 2, device=dev), toks.to(dev),
                              lens.to(dev))
        launched = (mm.q4k_gemv.launches + mm.q4k_gemm.launches - counts[0],
                    wkv6.wkv6_scan.launches - counts[1])
        logits = logits_head(params, x[torch.arange(2), lens.to(dev) - 1])
        out[str(dev)] = (launched, logits.cpu(), {k: v.cpu() for k, v in st.items()})
    (l_cpu, lg_cpu, st_cpu), (l_gpu, lg_gpu, st_gpu) = out["cpu"], out[str(card)]
    assert l_cpu == (0, 0)
    assert l_gpu == (8 * 2, 2 if T < 128 else 0)
    _close(lg_gpu, lg_cpu, 1e-2)
    for key in st_cpu:
        _close(st_gpu[key], st_cpu[key], 1e-2)


def _wkv4_args(B, T, lens, dev, seed=0):
    """V4 scan inputs; lane 0 starts from the initial state (pp at
    F32_MIN), the others from a random one."""
    from web_rwkv_gguf_tpu_torch.ops.wkv import F32_MIN

    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.5  # noqa: E731
    C = 768
    state = torch.stack([f(B, C), f(B, C).abs() + 0.1, f(B, C)], dim=-1)
    state[0] = torch.tensor([0.0, 0.0, F32_MIN], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    return (state, f(B, T, C), f(B, T, C), f(B, T, C), f(C), -torch.exp(f(C)), mask)


def _close_pp(got, want, rel):
    """pp against the plain version: absolute, at rel·max|pp| over the
    entries that left the F32_MIN sentinel (a relative check over the
    sentinel would hold nothing); the sentinel entries equal."""
    from web_rwkv_gguf_tpu_torch.ops.wkv import F32_MIN

    sentinel = want == F32_MIN
    assert torch.equal(got[sentinel], want[sentinel])
    _close(got[~sentinel], want[~sentinel], rel)


def _check_wkv4(args):
    """One launch of the V4 scan against its plain version: y at live
    positions, aa and bb at 1e-4·max|plain|, pp by _close_pp; a lane with
    every token padded keeps its state bit for bit. Returns the state."""
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv4

    before = wkv4.wkv4_scan.launches
    y1, s1 = wkv4.wkv4_scan(*args)
    assert wkv4.wkv4_scan.launches == before + 1
    y0, s0 = wkv4.wkv4_scan_plain(*args)
    mask = args[-1]
    _close(y1[mask], y0[mask], 1e-4)
    _close(s1[..., :2], s0[..., :2], 1e-4)
    _close_pp(s1[..., 2], s0[..., 2], 1e-4)
    idle = ~mask.any(1)
    assert torch.equal(s1[idle], args[0][idle])
    return s1


# T at and around each of the kernel's splits by T (one warp at T = 1, 8
# warps of one token to T = 8, segments of 1, 2, 4 and 8 tokens over 16
# warps to T = 16, 32, 64 and 128, rounds past 128)
WKV4_HOLES = ([(T, B) for T in (1, 8, 64, 127, 128) for B in (1, 4, 16)]
              + [(T, 4) for T in (9, 16, 17, 32, 33, 37, 65, 200)])


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [(1, 0, 1), (2,), (64, 40, 17, 0), (128, 128)])
def test_wkv4_scan_on_card(card, lens):
    """The V4 WKV scan against its plain version (_check_wkv4) on ragged
    lengths; a lane of length 0 keeps its state bit for bit."""
    _check_wkv4(_wkv4_args(len(lens), max(lens), lens, card))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", WKV4_HOLES)
def test_wkv4_scan_mask_holes_on_card(card, T, B):
    """Masks with holes (each token live with probability 0.7), lane 0 from
    the F32_MIN sentinel with its last token live; at B > 1 the last lane starts at the sentinel
    with every token padded and keeps its state bit for bit, F32_MIN too."""
    from web_rwkv_gguf_tpu_torch.ops.wkv import F32_MIN

    args = list(_wkv4_args(B, T, [T] * B, card, seed=T + B))
    g = torch.Generator(device=card).manual_seed(7 * T + B)
    mask = torch.rand(B, T, generator=g, device=card) < 0.7
    mask[0, -1] = True  # lane 0 leaves the sentinel
    if B > 1:
        mask[-1] = False
        args[0][-1] = torch.tensor([0.0, 0.0, F32_MIN], device=card)
    args[-1] = mask
    s1 = _check_wkv4(args)
    if B > 1:
        assert bool((s1[-1, :, 2] == F32_MIN).all())


@pytest.mark.cuda
def test_wkv4_scan_split_does_not_depend_on_T_on_card(card):
    """One lane of length 37 run at T = 37, 64 and 128. The kernel splits a
    chunk by T (segments of 4 tokens over 16 warps at T = 37 and 64, of 8
    at T = 128), so the runs may fold the same tokens in other segments and
    round them apart (pp + n·w in one step for n steps, the sums in another
    order): their final states agree at 1e-4·max, pp by _close_pp. Each
    run is held to the plain version too."""
    args = _wkv4_args(1, 128, (37,), card, seed=37)
    states = [_check_wkv4(tuple(a[:, :T] if a.dim() >= 2 and a.shape[1] == 128 else a
                                for a in args)) for T in (37, 64, 128)]
    for s1 in states[1:]:
        _close(s1[..., :2], states[0][..., :2], 1e-4)
        _close_pp(s1[..., 2], states[0][..., 2], 1e-4)


def _v45_model(card, version, seed=6):
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import load_model
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v4_gguf, make_v5_gguf

    kw = dict(n_layer=2, n_emb=256, n_vocab=512, n_hidden=1024, quantize=ggml.GgmlDType.Q4_K,
              head_quantize=ggml.GgmlDType.Q6_K, seed=seed)
    raw = make_v5_gguf(head_size=64, **kw) if version == 5 else make_v4_gguf(**kw)
    return raw, load_model(GgufFile(raw), device=card)


def _random_state56(info, B, dev, seed):
    """A random decode state for a V6/V5 (wkv) or V4 (aa, bb, pp) model;
    for V4 lane 0's pp at the F32_MIN sentinel."""
    from web_rwkv_gguf_tpu_torch.ops.wkv import F32_MIN

    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.5  # noqa: E731
    L, C, H = info.num_layer, info.num_emb, info.num_head
    state = {"att_shift": f(L, B, C), "ffn_shift": f(L, B, C)}
    if info.version.value == "v4":
        state.update({"aa": f(L, B, C), "bb": f(L, B, C).abs() + 0.1, "pp": f(L, B, C)})
        state["pp"][:, 0] = F32_MIN
    else:
        state["wkv"] = f(L, B, H, 64, 64)
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("B", LAYER7_BATCHES)
@pytest.mark.parametrize("version", [5, 4])
def test_layer_scan56_v5_v4_on_card(card, version, B):
    """The whole-stack decode kernel's version-5 and version-4 bodies
    against their plain versions on a two-layer model, from a random
    state, one lane frozen at B ≥ 3: each layer as a one-layer slice on
    the plain chain's input, every output at 2^-8·max of that layer (as
    test_layer_scan56_on_card; pp absolutely, _close_pp); the frozen
    lane's state is kept bit for bit."""
    from web_rwkv_gguf_tpu_torch.models import embed_tokens, prepare_decode
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer56

    _, (info, params) = _v45_model(card, version)
    mega = prepare_decode(params, info, B)["mega56"]
    assert mega["version"] == version
    state = _random_state56(info, B, card, B)
    x = embed_tokens(params, torch.arange(B, device=card)[:, None] * 7 + 1)[:, 0]
    mask = torch.ones(B, device=card)
    if B >= 3:
        mask[1] = 0.0
    before = layer56.layer_scan56.launches
    for i in range(info.num_layer):
        m_i = layer56.mega_layers(mega, i, i + 1)
        s_i = {k: v[i:i + 1] for k, v in state.items()}
        x1, s1 = layer56.layer_scan56(m_i, s_i, x, mask, None, LN_EPS, GN_EPS, first_layer=i)
        x0, s0 = layer56.layer_scan56_plain(m_i, s_i, x, mask, None, LN_EPS, GN_EPS, i)
        live = mask > 0
        _close(x1[live], x0[live], 2.0 ** -8)
        for key in s0:
            if key == "pp":
                _close_pp(s1[key], s0[key], 2.0 ** -8)
            else:
                _close(s1[key], s0[key], 2.0 ** -8)
            if B >= 3:
                assert torch.equal(s1[key][:, 1], s_i[key][:, 1])
        x = x0
    assert layer56.layer_scan56.launches == before + info.num_layer


@pytest.mark.cuda
def test_v4_kernels_refuse_what_they_do_not_take(card):
    from web_rwkv_gguf_tpu_torch.models import init_state, prepare_decode
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer56, wkv4

    args = list(_wkv4_args(1, 4, (4,), card))
    with pytest.raises(ValueError):  # u of the wrong shape
        wkv4.wkv4_scan(*args[:4], args[4][:6], *args[5:])
    with pytest.raises(ValueError):  # a state without its three rows
        wkv4.wkv4_scan(args[0][..., :2], *args[1:])
    _, (info, params) = _v45_model(card, 4)
    mega = prepare_decode(params, info, 1)["mega56"]
    state = init_state(info, 17, device=card)
    z = lambda *s: torch.zeros(*s, device=card)  # noqa: E731
    with pytest.raises(ValueError):  # 17 lanes
        layer56.layer_scan56(mega, state, z(17, 256), z(17), None, 1e-5, 64e-5)
    with pytest.raises(ValueError):  # a V6 state on a V4 model
        layer56.layer_scan56(mega, {"att_shift": z(2, 1, 256), "ffn_shift": z(2, 1, 256),
                                    "wkv": z(2, 1, 4, 64, 64)}, z(1, 256), z(1), None,
                             1e-5, 64e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5, 128])
@pytest.mark.parametrize("version", [5, 4])
def test_v5_v4_forward_routes_through_the_kernels_on_card(card, version, T):
    """A V5 or V4 chunk on the card through the per-layer path: the
    quantized matmuls on the Q4_K kernels (8 per layer for V5, 7 for V4),
    the V5 WKV on ``wkv6_scan`` below T=128 (T=1 included) and on the
    chunk-parallel form from it, the V4 WKV on ``wkv4_scan`` at every T;
    logits and state match the CPU within chip_smoke.py's card-vs-CPU
    limits: 1e-2·max|CPU| for the logits, the shifts and layer 0's WKV
    state, 3e-2 of the layer's max for layer 1's (V4's aa and bb weigh
    tokens by e^k, so a bf16 operand flip upstream that moves k moves
    them by that factor; pp is finite here, every lane has run)."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import forward_chunk, init_state, load_model, logits_head
    from web_rwkv_gguf_tpu_torch.ops.cuda import wkv4, wkv6

    raw, _ = _v45_model(card, version, seed=4)
    scan = wkv6.wkv6_scan if version == 5 else wkv4.wkv4_scan
    toks = torch.from_numpy(np.random.default_rng(T).integers(0, 512, (2, T)))
    lens = torch.tensor([T, max(T - 3, 1)])
    out = {}
    for dev in ("cpu", card):
        info, params = load_model(GgufFile(raw), device=dev)
        counts = (mm.q4k_gemv.launches + mm.q4k_gemm.launches, scan.launches)
        x, st = forward_chunk(info, params, init_state(info, 2, device=dev), toks.to(dev),
                              lens.to(dev))
        launched = (mm.q4k_gemv.launches + mm.q4k_gemm.launches - counts[0],
                    scan.launches - counts[1])
        logits = logits_head(params, x[torch.arange(2), lens.to(dev) - 1])
        out[str(dev)] = (launched, logits.cpu(), {k: v.cpu() for k, v in st.items()})
    (l_cpu, lg_cpu, st_cpu), (l_gpu, lg_gpu, st_gpu) = out["cpu"], out[str(card)]
    assert l_cpu == (0, 0)
    n_mat = 8 if version == 5 else 7
    assert l_gpu == (n_mat * 2, 2 if version == 4 or T < 128 else 0)
    _close(lg_gpu, lg_cpu, 1e-2)
    for key in st_cpu:
        for i in range(info.num_layer):
            later = i > 0 and "shift" not in key
            _close(st_gpu[key][i], st_cpu[key][i], 3e-2 if later else 1e-2)


# the forms of the f32-scale and Q5_K/Q2_K kernels: (block type, M, K)
QS_FORMS = [("Q8_0", 2048, 2048), ("Q4_0", 768, 768), ("Q4_1", 256, 96), ("Q5_0", 768, 3072),
            ("Q5_1", 768, 768), ("Q4_K", 256, 384), ("Q6_K", 256, 384), ("Q3_K", 256, 384)]
QKB_FORMS = [("Q5_K", 768, 768), ("Q5_K", 3072, 768), ("Q2_K", 768, 768)]


def _matrix(kind, m, k, seed, dev):
    from web_rwkv_gguf_tpu_torch.models import Matrix

    q = getattr(ggml, f"quantize_{kind.lower()}")
    return Matrix.from_gguf_blocks(ggml.GgmlDType[kind], _weights(m, k, q, seed), (m, k),
                                   device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("op,n", [("gemv", 1), ("gemv", 3), ("gemv", 8), ("gemm", 3),
                                  ("gemm", 64), ("gemm", 130)])
@pytest.mark.parametrize("kind,m,k", QS_FORMS)
def test_qs_kernels_on_card(card, kind, m, k, op, n):
    """``qs_gemv`` / ``qs_gemm`` against their plain versions over every
    f32-scale form: i8 bytes per 32 (Q8_0) and per 16 (Q6_K, Q3_K rows
    without whole super-blocks), u8 bytes with offsets (Q5_0, Q5_1, Q4_1
    at K=96, an odd multiple of 32), nibbles with offsets (Q4_0, Q4_K at
    K=384)."""
    mat = _matrix(kind, m, k, m + k, card)
    a = mat.arrays
    assert "scales" in a
    kernel, plain = getattr(mm, f"qs_{op}"), getattr(mm, f"qs_{op}_plain")
    x = _x(n, k, n, card)
    before = kernel.launches
    got = kernel(x, a["codes"], a["scales"], a.get("mins"))
    assert kernel.launches == before + 1
    _close(got, plain(x, a["codes"], a["scales"], a.get("mins")), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("op,n", [("gemv", 1), ("gemv", 4), ("gemv", 8), ("gemm", 3),
                                  ("gemm", 64), ("gemm", 130)])
@pytest.mark.parametrize("kind,m,k", QKB_FORMS)
def test_qkb_kernels_on_card(card, kind, m, k, op, n):
    """``qkb_gemv`` / ``qkb_gemm`` against their plain versions (Q5_K's
    32-groups, Q2_K's 16-groups)."""
    a = _matrix(kind, m, k, m + k, card).arrays
    kernel, plain = getattr(mm, f"qkb_{op}"), getattr(mm, f"qkb_{op}_plain")
    args = (_x(n, k, n, card), *(a[key] for key in ("codes", "sc6", "mn6", "d8", "dm8")))
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1
    _close(got, plain(*args), 1e-4)


@pytest.mark.cuda
def test_qs_kernels_sign_extend_on_card(card):
    """Q8_0 codes −128 and −127 multiply as signed on the gemv and the
    GEMM (a file may hold −128)."""
    codes = torch.zeros(8, 64, dtype=torch.int8, device=card)
    codes[0, 0], codes[0, 1], codes[1, 5] = -128, -127, 127
    scales = torch.full((8, 2), 0.5, device=card)
    x = torch.zeros(2, 64, device=card)
    x[:, 0], x[:, 1], x[:, 5] = 1.0, 2.0, 4.0
    for fn in (mm.qs_gemv, mm.qs_gemm):
        y = fn(x, codes, scales)
        assert y[0, 0].item() == 0.5 * (-128 - 2 * 127) and y[0, 1].item() == 0.5 * 127 * 4


@pytest.mark.cuda
def test_qs_kernels_refuse_what_they_do_not_take(card):
    a = _matrix("Q8_0", 256, 512, 1, card).arrays
    x = _x(9, 512, 0, card)
    with pytest.raises(ValueError):  # 9 rows on the gemv
        mm.qs_gemv(x, a["codes"], a["scales"])
    with pytest.raises(ValueError):  # groups of 64
        mm.qs_gemm(x, a["codes"], a["scales"][:, :8].contiguous())
    with pytest.raises(ValueError):  # nibbles of another dtype
        mm.qs_gemm(x, a["codes"][:, :256].contiguous(), a["scales"][:, :16].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("version,kind", [("v7", "Q5_K"), ("v7", "Q8_0"), ("v6", "Q5_K"),
                                          ("v6", "Q8_0"), ("v7", "Q2_K"), ("v6", "Q5_1"),
                                          ("v7", "INT8"), ("v6", "INT8")])
def test_layer_scan_stack_forms_on_card(card, version, kind, B):
    """The whole-stack decode kernels on Q5_K / Q2_K (native byte-kind
    slots), Q8_0 / Q5_1 (f32-scale byte slots) and Int8-requantized
    (f32-scale slots in 128-groups) stacks against their plain versions,
    from a random state, one lane frozen at B ≥ 3: each layer as a
    one-layer slice on the plain chain's input, every output at 2^-8·max
    of that layer (as test_layer_scan56_on_card); the frozen lane's state
    is kept exactly."""
    _hold_stack_layers(card, version, kind, B, flips=False)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("version,kind", [("v7", "Q6_K"), ("v6", "Q6_K"), ("v7", "Q3_K"),
                                          ("v7", "Q4_0"), ("v6", "Q4_1"), ("v7", "BF16"),
                                          ("v6", "BF16")])
def test_layer_scan_new_slots_on_card(card, version, kind, B):
    """The same for Q6_K / Q3_K (native Q6_K slots), Q4_0 / Q4_1 (f32-scale
    nibble slots) and f16 files loaded as bf16 (dense slots). A version 6
    layer's x is held as chip_smoke.py holds it: within 2^-8·max of the
    plain version, or else within 4 times that with its staged f32
    products (r/k/v/g, the FFN receptance) within 2^-8·max of the plain
    version's and x within 1e-4·max of its replay from the kernel's own
    staged operands (``layer56.replay_staged``): the other order of f32
    sums flips bf16 roundings of the FFN's relu² inputs, whose sum through
    the FFN value can move x past one bf16 step (seen: v6 Q4_1 at B=9, 2
    of 2,048 elements at 1.14 of the bound)."""
    _hold_stack_layers(card, version, kind, B, flips=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B", LAYER7_BATCHES)
@pytest.mark.parametrize("kind", LAYER7_FORMS)
def test_layer_scan7_every_form_on_card(card, kind, B):
    """The RWKV-7 whole-stack kernel on a stack of every slot form at every
    NB template, layer by layer as test_layer_scan_stack_forms_on_card
    holds it (2^-8·max of each layer; a frozen lane keeps its state)."""
    _hold_stack_layers(card, "v7", kind, B, flips=False)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("kind", ["Q4_K", "INT8", "BF16"])
def test_layer_scan7_same_signed_ffn_on_card(card, kind, B):
    """The same with LN2's weight 16 times larger and its bias 4 up: the
    FFN key sees large inputs, and the FFN value large same-signed relu²
    ones (its f32 sums of 16-element tensor-core terms must not drift);
    held at 2^-8·max of each layer."""
    _hold_stack_layers(card, "v7", kind, B, flips=False, ffn_gain=16.0)


# every slot form an RWKV-6 stack takes (layer7.stack_matrix; Q4_0 and Q4_1
# as f32-scale nibbles)
LAYER56_FORMS = ["Q4_K", "Q5_K", "Q2_K", "Q8_0", "Q6_K", "Q3_K", "Q4_0", "Q4_1", "INT8", "BF16"]


@pytest.mark.cuda
@pytest.mark.parametrize("B", LAYER7_BATCHES)
@pytest.mark.parametrize("kind", LAYER56_FORMS)
def test_layer_scan56_every_form_on_card(card, kind, B):
    """The RWKV-6 whole-stack kernel on a stack of every slot form at every
    NB template, layer by layer as test_layer_scan_new_slots_on_card holds
    a version 6 stack (2^-8·max of each layer, x through its staged
    operands where the other order of f32 sums flips bf16 roundings; a
    frozen lane keeps its state)."""
    _hold_stack_layers(card, "v6", kind, B, flips=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("kind", ["Q4_K", "INT8", "BF16"])
def test_layer_scan56_same_signed_ffn_on_card(card, kind, B):
    """test_layer_scan7_same_signed_ffn_on_card for RWKV-6: LN2's weight 16
    times larger and its bias 4 up, so the FFN value takes large
    same-signed relu² inputs (their f32 sums of 16-element tensor-core
    terms must not drift); held as test_layer_scan_new_slots_on_card holds
    a version 6 layer: x within 2^-8·max of the plain version, or within 4
    times that with its staged f32 products within 2^-8·max and x within
    1e-4·max of its replay from the kernel's own staged operands (which a
    drifting sum would leave); the large relu² inputs flip bf16 roundings
    of khid, and the FFN value carries them to x (seen: Q4_K at B=4, 2 of
    768 elements at 1.41 of the bound)."""
    _hold_stack_layers(card, "v6", kind, B, flips=True, ffn_gain=16.0)


def _hold_stack_layers(card, version, kind, B, flips, ffn_gain=None):
    """Each layer of a two-layer stack of ``kind`` (a GGML block type,
    INT8 for an f16 file requantized at load, BF16 for an f16 file loaded
    as it is) as a one-layer launch against its plain version (module
    tests above); ``flips``: version 6 layers may pass through their
    staged operands; ``ffn_gain``: the stack's LN2 weight times that and
    its bias 4 up."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import embed_tokens, load_model, prepare_decode
    from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7, layer56
    from web_rwkv_gguf_tpu_torch.quant import QuantScheme
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf, make_v7_gguf

    requant, dense = kind == "INT8", kind == "BF16"
    kw = dict(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024, seed=8,
              **({} if requant else dict(dtype=np.float16) if dense
                 else dict(quantize=ggml.GgmlDType[kind], head_quantize=ggml.GgmlDType.Q6_K)))
    raw = (make_v7_gguf(**kw) if version == "v7"
           else make_v6_gguf(**kw, rank_tm=32, rank_td=64))
    info, params = load_model(GgufFile(raw), quant=QuantScheme.INT8 if requant else None,
                              device=card)
    v7 = version == "v7"
    mega = prepare_decode(params, info, B)["mega7" if v7 else "mega56"]
    if ffn_gain is not None:
        mega = {**mega, "ln2": (mega["ln2"][0] * ffn_gain, mega["ln2"][1] + 4.0)}
    state = _random_state56(info, B, card, B)
    x = embed_tokens(params, torch.arange(B, device=card)[:, None] * 7 + 1)[:, 0]
    mask = torch.ones(B, device=card)
    if B >= 3:
        mask[1] = 0.0
    mod = layer7 if v7 else layer56
    scan = layer7.layer_scan7 if v7 else layer56.layer_scan56
    before, v_first = scan.launches, None
    for i in range(info.num_layer):
        m_i = mod.mega_layers(mega, i, i + 1)
        s_i = {k: v[i:i + 1] for k, v in state.items()}
        if v7:
            eps = (LN_EPS, GN_EPS, L2_EPS)
            x1, s1, _ = layer7.layer_scan7(m_i, s_i, x, mask, None, *eps, (v_first, i))
            x0, s0, v_first = layer7.layer_scan7_plain(m_i, s_i, x, mask, None, *eps,
                                                       (v_first, i))
        else:
            st_k, st_p = {}, {}
            x1, s1 = layer56.layer_scan56(m_i, s_i, x, mask, None, LN_EPS, GN_EPS,
                                          first_layer=i, staged=st_k)
            x0, s0 = layer56.layer_scan56_plain(m_i, s_i, x, mask, None, LN_EPS, GN_EPS, i,
                                                staged=st_p)
        live = mask > 0
        bound = 2.0 ** -8 * x0[live].abs().max().item()
        if flips and not v7 and (x1[live] - x0[live]).abs().max().item() > bound:
            for key in ("rkvg", "rf"):
                _close(st_k[key].float(), st_p[key].float(), 2.0 ** -8)
            rep = layer56.replay_staged(mega, i, state, x, mask, LN_EPS, GN_EPS, st_k)
            _close(x1[live], rep["x"][live], 1e-4)
            _close(x1[live], x0[live], 4 * 2.0 ** -8)
        else:
            _close(x1[live], x0[live], 2.0 ** -8)
        for key in s0:
            _close(s1[key], s0[key], 2.0 ** -8)
            if B >= 3:
                assert torch.equal(s1[key][:, 1], s_i[key][:, 1])
        x = x0
    assert scan.launches == before + info.num_layer


def _grouped(kind, m, k, seed, dev):
    """Three [m, k] matrices of ``kind`` (a GGML block type or INT8) and
    their grouped operands."""
    from web_rwkv_gguf_tpu_torch.models import Matrix, group_gemv_matrices
    from web_rwkv_gguf_tpu_torch.quant import QuantScheme

    mats = []
    for i in range(3):
        if kind == "INT8":
            w = (np.random.default_rng(seed + i).normal(size=(m, k)) * 0.05).astype(np.float16)
            mats.append(Matrix.from_f16(w, QuantScheme.INT8, device=dev))
        else:
            raw = _weights(m, k, getattr(ggml, f"quantize_{kind.lower()}"), seed + i)
            mats.append(Matrix.from_gguf_blocks(ggml.GgmlDType[kind], raw, (m, k), device=dev))
    return mats, group_gemv_matrices(mats)


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("kind,m,k", [("Q4_K", 768, 768), ("Q4_0", 768, 768),
                                      ("Q5_K", 768, 768), ("Q6_K", 768, 768),
                                      ("Q8_0", 768, 768), ("INT8", 768, 768),
                                      ("Q4_K", 2048, 2048), ("Q2_K", 256, 512),
                                      ("Q8_0", 768, 800), ("Q8_0", 256, 4128),
                                      ("Q4_0", 256, 4160)])
def test_quant_gemv_grouped_on_card(card, kind, m, k, n):
    """The grouped r/k/v gemv against its plain version, each matrix with
    its own input rows (Q2_K: byte codes in 16-groups; K = 800 in one
    slice that is no multiple of 256, K = 4128 and 4160 in two whole
    slices of 2048 and a short one)."""
    mats, grouped = _grouped(kind, m, k, m + k, card)
    assert grouped is not None
    xs = torch.stack([_x(n, k, n + i, card) for i in range(3)])
    before = mm.quant_gemv_grouped.launches
    got = mm.quant_gemv_grouped(xs, mats[0].kind, grouped, m, k)
    assert mm.quant_gemv_grouped.launches == before + 1
    _close(got, mm.quant_gemv_grouped_plain(xs, mats[0].kind, grouped, m, k), 1e-4)


@pytest.mark.cuda
def test_quant_gemv_grouped_refuses_what_it_does_not_take(card):
    mats, grouped = _grouped("Q4_K", 256, 512, 3, card)
    xs = _x(3, 512, 0, card).view(3, 1, 512)
    for bad_xs in (xs[:2], torch.zeros(3, 9, 512, device=card), xs[..., :256]):
        with pytest.raises(ValueError):
            mm.quant_gemv_grouped(bad_xs, "qk", grouped, 256, 512)
    with pytest.raises(ValueError):  # scales of another shape
        mm.quant_gemv_grouped(xs, "qk", {**grouped, "scales": grouped["scales"][:, :128]},
                              256, 512)
    with pytest.raises(ValueError):  # codes on the CPU
        mm.quant_gemv_grouped(xs, "qk", {**grouped, "codes": [c.cpu() for c in
                                                                 grouped["codes"]]}, 256, 512)


@pytest.mark.cuda
def test_unrolled_decode_routes_through_the_grouped_gemv_on_card(card):
    """A B=1 decode step on ``unroll_params``: one grouped launch per
    layer, and the same logits as the per-matrix gemvs of the loaded
    params within the card-vs-CPU limit (both in the exact-weight class;
    a flipped bf16 operand rounding moves them apart)."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import (
        forward_chunk, init_state, load_model, logits_head, unroll_params,
    )
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=2, n_emb=768, head_size=64, n_vocab=512, n_hidden=3072,
                       quantize=ggml.GgmlDType.Q4_K, head_quantize=ggml.GgmlDType.Q6_K, seed=9)
    info, params = load_model(GgufFile(raw), device=card)
    out = []
    for p in (unroll_params(params), params):
        before = mm.quant_gemv_grouped.launches
        tok = torch.tensor([[17]], device=card)
        x, _ = forward_chunk(info, p, init_state(info, 1, device=card), tok,
                             torch.tensor([1], device=card))
        out.append((logits_head(p, x[:, 0]), mm.quant_gemv_grouped.launches - before))
    assert [n for _, n in out] == [info.num_layer, 0]
    _close(out[0][0], out[1][0], 1e-2)


# the engine's requantized forms at the RWKV-7 0.1B layer shapes
REQUANT_SHAPES = [(768, 768), (3072, 768), (768, 3072)]


def _requant_matrix(scheme, m, k, seed, dev):
    from web_rwkv_gguf_tpu_torch.models import Matrix
    from web_rwkv_gguf_tpu_torch.quant import QuantScheme

    w = (np.random.default_rng(seed).normal(size=(m, k)) * 0.05).astype(np.float16)
    return Matrix.from_f16(w, QuantScheme[scheme], device=dev)


def _requant_call(mat, op):
    """The kernel, its plain version and the weight operands of ``op`` for
    an Int8 (``qs_*``, groups of 128) or NF4 / SF4 (``nf4_*``) matrix."""
    from web_rwkv_gguf_tpu_torch.models.matrix import int8_operands

    a = mat.arrays
    if mat.kind == "int8":
        family, ops = "qs", (a["codes"], *int8_operands(a, op == "gemm"))
    else:
        family, ops = "nf4", (a["codes"], a["absmax"], a["lut"])
    return getattr(mm, f"{family}_{op}"), getattr(mm, f"{family}_{op}_plain"), ops


@pytest.mark.cuda
@pytest.mark.parametrize("op,n", [("gemv", 1), ("gemv", 4), ("gemv", 8), ("gemm", 3),
                                  ("gemm", 64), ("gemm", 130)])
@pytest.mark.parametrize("scheme", ["INT8", "NF4", "SF4"])
@pytest.mark.parametrize("m,k", REQUANT_SHAPES)
def test_requant_kernels_on_card(card, m, k, scheme, op, n):
    """The Int8 forms of ``qs_gemv`` / ``qs_gemm`` (u8 codes in 128-groups,
    offsets −mn) and ``nf4_gemv`` / ``nf4_gemm`` with the NF4 and the SF4
    codebook against their plain versions."""
    kernel, plain, ops = _requant_call(_requant_matrix(scheme, m, k, m + k, card), op)
    x = _x(n, k, n, card)
    before = kernel.launches
    got = kernel(x, *ops)
    assert kernel.launches == before + 1
    _close(got, plain(x, *ops), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 64])
@pytest.mark.parametrize("form", ["Q5_K", "Q8_0", "INT8", "NF4"])
def test_gemm_on_same_signed_inputs_on_card(card, form, n):
    """The dequant-GEMM on inputs that are all ≥ 0 (relu², the FFN value's
    input) at K = 3072: its products' sum is many times |y| where the
    offset term cancels it. At n = 64 the tensor cores' truncating sums,
    chained through a row, would drift from the plain version's (each
    mma now starts from zero); at n = 3 (M = 768: 12 tiles of 64 rows)
    the CUDA-core path forms each weight with its offset first
    (csrc/qk_gemm.cu)."""
    m, k = 768, 3072
    x = torch.relu(_x(n, k, 5, card)) ** 2
    if form in ("INT8", "NF4"):
        kernel, plain, ops = _requant_call(_requant_matrix(form, m, k, 11, card), "gemm")
    else:
        a = _matrix(form, m, k, 11, card).arrays
        if form == "Q5_K":
            kernel, plain = mm.qkb_gemm, mm.qkb_gemm_plain
            ops = tuple(a[key] for key in ("codes", "sc6", "mn6", "d8", "dm8"))
        else:
            kernel, plain, ops = mm.qs_gemm, mm.qs_gemm_plain, (a["codes"], a["scales"])
    _close(kernel(x, *ops), plain(x, *ops), 1e-4)


def _random_form(form, m, k, seed, dev):
    """Random operands of one weight form, drawn on the card: the kernel
    family (``mm.<family>_gemv`` / ``_gemm``) and its operands after x.
    Forms: q4k, q6k, Q5_K, Q2_K (native factors), nf4, and qs_<codes>_<gs>
    with _min for offsets (codes i8, u8 or nib; f32 group scales)."""
    from web_rwkv_gguf_tpu_torch.quant.formats import NF4_QUANTILES

    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=dtype)

    def floats(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    u8 = torch.uint8
    if form == "q4k":
        return "q4k", (ints(0, 256, (m, k // 2), u8), ints(0, 64, (m, k // 32), u8),
                       ints(0, 64, (m, k // 32), u8), floats(m, k // 256) * 1e-2,
                       floats(m, k // 256) * 1e-2)
    if form == "q6k":
        return "q6k", (ints(-32, 32, (m, k), torch.int8), ints(-128, 128, (m, k // 16), torch.int8),
                       floats(m, k // 256) * 1e-3)
    if form in ("Q5_K", "Q2_K"):
        gs, bound = (32, 32) if form == "Q5_K" else (16, 4)
        return "qkb", (ints(0, bound, (m, k), u8), ints(0, 64, (m, k // gs), u8),
                       ints(0, 64, (m, k // gs), u8), floats(m, k // 256) * 1e-2,
                       floats(m, k // 256) * 1e-2)
    if form == "nf4":
        return "nf4", (ints(0, 256, (m, k // 2), u8), floats(m, k // 64),
                       torch.tensor(NF4_QUANTILES, device=dev))
    _, store, gs, *offsets = form.split("_")
    gs = int(gs)
    codes = {"nib": lambda: ints(0, 256, (m, k // 2), u8), "u8": lambda: ints(0, 256, (m, k), u8),
             "i8": lambda: ints(-128, 128, (m, k), torch.int8)}[store]()
    return "qs", (codes, floats(m, k // gs) * 1e-2, floats(m, k // gs) * 1e-1 if offsets else None)


def _hold_form(card, form, op, m, k, n, seed):
    family, ops = _random_form(form, m, k, seed, card)
    kernel, plain = getattr(mm, f"{family}_{op}"), getattr(mm, f"{family}_{op}_plain")
    x = _x(n, k, seed + n, card)
    before = kernel.launches
    got = kernel(x, *ops)
    assert kernel.launches == before + 1
    _close(got, plain(x, *ops), 1e-4)


# every code storage and scale source of the dequant-GEMM, with the K values
# each takes in turn (byte codes at odd multiples of 32: 96, 1056; nibbles
# at 384 and 7168)
GEMM_FORMS = [("q4k", (512, 7168)), ("q6k", (768, 2048)), ("Q5_K", (768, 3072)),
              ("Q2_K", (512, 768)), ("qs_i8_32", (1056, 2048)), ("qs_u8_32_min", (96, 1056)),
              ("qs_nib_32", (384, 7168)), ("qs_nib_32_min", (384, 7168)),
              ("qs_i8_16", (1056, 768)), ("qs_u8_128_min", (768, 3072)), ("nf4", (384, 3072))]


@pytest.mark.cuda
@pytest.mark.parametrize("n", GEMM_ROWS)
@pytest.mark.parametrize("form,ks", GEMM_FORMS)
def test_gemm_tile_edges_on_card(card, form, ks, n):
    """The dequant-GEMM at every form against its plain version, n at and
    around each tile edge; M ragged against the 64-row tile (100, 200) or
    not (832), K and M taken in turn across n."""
    i = GEMM_ROWS.index(n)
    _hold_form(card, form, "gemm", (100, 200, 832)[i % 3], ks[i % 2], n, seed=i)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 64])
@pytest.mark.parametrize("form", ["qs_i8_32", "qs_u8_128_min", "nf4"])
def test_gemm_heads_on_card(card, form, n):
    """A vocabulary head's shape (M = 65536, K = 2048) at n = 4 and 64 for
    Q8_0 (i8 bytes), Int8 (u8 with offsets in 128-groups) and NF4."""
    _hold_form(card, form, "gemm", 65536, 2048, n, seed=n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("k", [768, 2048, 7168])
@pytest.mark.parametrize("form", ["qs_i8_32", "qs_u8_128_min", "qs_nib_32_min", "Q5_K", "nf4"])
def test_gemv_rows_on_card(card, form, k, n):
    """qgemv.cuh through ``qs_gemv``, ``qkb_gemv`` and ``nf4_gemv`` at n =
    1..8: M = 37 at even n (fewer rows than one pass of the persistent
    grid, and not a multiple of a warp's rows: 2 at K = 768 for byte
    codes, 4 for nibbles and codebook indices) and 20,005 at odd n
    (several passes)."""
    _hold_form(card, form, "gemv", 37 if n % 2 == 0 else 20005, k, n, seed=k + n)


@pytest.mark.cuda
def test_nf4_kernels_refuse_what_they_do_not_take(card):
    a = _requant_matrix("NF4", 256, 512, 1, card).arrays
    with pytest.raises(ValueError):  # 9 rows on the gemv
        mm.nf4_gemv(_x(9, 512, 0, card), a["codes"], a["absmax"], a["lut"])
    with pytest.raises(ValueError):  # a codebook of another size
        mm.nf4_gemm(_x(2, 512, 0, card), a["codes"], a["absmax"], a["lut"][:8].contiguous())
    with pytest.raises(ValueError):  # absmax per 32
        mm.nf4_gemm(_x(2, 512, 0, card), a["codes"], a["absmax"].repeat(1, 2), a["lut"])


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["INT8", "NF4"])
def test_requant_forward_routes_through_the_kernels_on_card(card, scheme):
    """A requantized RWKV-7 model (C=256, FFN 1024) at B=4: a decode step
    through forward_chunk takes the scheme's gemv for all 12 layer
    matrices (n·groups at most 4 · 32 for NF4's FFN value), a prefill
    chunk of T=9 its GEMM; logits and layer 0's state agree with the CPU
    at the card-vs-CPU limit of chip_smoke.py."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import init_state, load_model
    from web_rwkv_gguf_tpu_torch.models import forward_chunk, logits_head
    from web_rwkv_gguf_tpu_torch.quant import QuantScheme
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       seed=12)
    family = "qs" if scheme == "INT8" else "nf4"
    gemv, gemm = getattr(mm, f"{family}_gemv"), getattr(mm, f"{family}_gemm")
    outs = {}
    for dev in (card, torch.device("cpu")):
        info, params = load_model(GgufFile(raw), quant=QuantScheme[scheme], device=dev)
        st = init_state(info, 4, device=dev)
        counts = (gemv.launches, gemm.launches)
        logits = []
        for T in (1, 9):
            toks = torch.arange(4 * T, device=dev).view(4, T) * 7 % 512
            x, st = forward_chunk(info, params, st, toks, torch.full((4,), T, device=dev))
            logits.append(logits_head(params, x[:, -1]).cpu())
        if dev.type == "cuda":
            # T=1: 6 matrices x 2 layers on the gemv; T=9 (n=36): the GEMM
            assert (gemv.launches - counts[0], gemm.launches - counts[1]) == (12, 12)
        outs[dev.type] = (logits, {k: v.cpu() for k, v in st.items()})
    for a, b in zip(outs["cuda"][0], outs["cpu"][0]):
        _close(a, b, 1e-2)
    for key, v in outs["cpu"][1].items():
        _close(outs["cuda"][1][key][0], v[0], 1e-2)


# --------------------------------------------------------------------------
# the compiled step: the Engine's forward and the decode segment as CUDA
# graph replays (runtime/graph.py) against the eager step
# --------------------------------------------------------------------------

GRAPH_LENGTHS = (300, 77, 40, 9)  # chip_smoke.py's B=4 traffic
GRAPH_TOKENS = 33  # the first token and one segment of 32


def _graph_model(card, n_layer=2):
    """A two-layer RWKV-7 Q4_K_M model (Q4_K layers, Q6_K head) at C=256."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import load_model
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=n_layer, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       quantize=ggml.GgmlDType.Q4_K, head_quantize=ggml.GgmlDType.Q6_K,
                       seed=4)
    return load_model(GgufFile(raw), device=card)


def _graph_traffic(eng, prompts):
    """``generate`` twice (the second from a reset state replays what the
    first captured), then a FULL and LAST ``infer``: the tokens, the state
    after each, the logits rows and the launches by kernel and shape."""
    from web_rwkv_gguf_tpu_torch.runtime import RnnInput, RnnInputBatch, RnnOption
    from web_rwkv_gguf_tpu_torch.runtime import graph

    before = graph.launch_counts()
    out = []
    for _ in range(2):
        eng.reset_state()
        out.append(eng.generate(prompts, GRAPH_TOKENS))
        out.append({k: v.clone() for k, v in eng.state.items()})
    inp = RnnInput([RnnInputBatch(list(p[:60]), RnnOption.FULL if b == 0 else RnnOption.LAST)
                    for b, p in enumerate(prompts)], 32)
    while inp.num_token:
        out.append([o.copy() for o in eng.infer(inp).batches])
    out.append({k: v.clone() for k, v in eng.state.items()})
    torch.cuda.synchronize()
    return out, graph.count_delta(before, graph.launch_counts())


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 1])
def test_graph_engine_equals_the_eager_step_on_card(card, B):
    """The Engine's graph replays (the default on the card) against
    ``graph=False`` on the same params: B=4 on prompts of 300/77/40/9
    tokens (chunks of T = 128 and below, the whole-stack decode) and B=1
    on an 8-token prompt (the unrolled decode with the grouped r/k/v gemv),
    each generating twice and then a FULL chunk: tokens, state and logits
    bit for bit, launches by kernel and shape exact."""
    from web_rwkv_gguf_tpu_torch.models import unroll_params
    from web_rwkv_gguf_tpu_torch.runtime import Engine

    info, params = _graph_model(card)
    if B == 1:  # the B=1 serve's arrangement: per-layer views, r/k/v grouped
        params = unroll_params(params)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 512, n)]
               for n in (GRAPH_LENGTHS if B == 4 else (8,))]
    runs = {}
    for graphed in (True, False):
        eng = Engine(info, params, B, device=card, unroll=B != 1,
                     graph=None if graphed else False)
        assert eng.graph == graphed
        runs[graphed] = _graph_traffic(eng, prompts)
        if graphed:
            assert eng._graphs.graphs and all(
                a is eng._graphs.state[k] for k, a in eng.state.items())
    (got, got_n), (want, want_n) = runs[True], runs[False]
    assert got_n == want_n
    assert _same(got, want)


@pytest.mark.cuda
def test_graph_generator_advances_its_sampler_on_card(card):
    """``make_generator`` on the card captures its segment; two calls of a
    sampled segment from one state and one ``torch.Generator`` draw
    different tokens, the generator advancing as the eager segment
    advances it; the greedy segment equals the eager one bit for bit."""
    from web_rwkv_gguf_tpu_torch.models import init_state, make_generator, prepare_decode

    info, params = _graph_model(card)
    params = prepare_decode(params, info, 2)
    tok = torch.tensor([[5], [9]], device=card)
    outs = {}
    for graph in (None, False):
        greedy = make_generator(info, steps=16, graph=graph)
        sampled = make_generator(info, steps=16, temperature=1.0, graph=graph)
        gen = torch.Generator(device=card).manual_seed(3)
        state = init_state(info, 2, device=card)
        g_toks, _, g_state, _, _ = greedy(params, state, tok)
        g_state = {k: v.clone() for k, v in g_state.items()}
        draws = [sampled(params, state, tok, gen)[0].clone() for _ in range(2)]
        outs[graph] = (g_toks, g_state, draws, gen.get_state())
    assert _same(outs[None][0], outs[False][0]) and _same(outs[None][1], outs[False][1])
    assert not torch.equal(*outs[None][2])
    assert _same(outs[None][2], outs[False][2])
    assert torch.equal(outs[None][3], outs[False][3])


def _graph_model_v6(card):
    """A two-layer RWKV-6 Q4_K_M model (Q4_K layers, Q6_K head) at C=256."""
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import load_model
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf

    raw = make_v6_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       quantize=ggml.GgmlDType.Q4_K, head_quantize=ggml.GgmlDType.Q6_K,
                       seed=5)
    return load_model(GgufFile(raw), device=card)


def _example_hooks(app, num_layer):
    from importlib import import_module

    return getattr(import_module(f"web_rwkv_gguf_tpu_torch.apps.{app}"),
                   f"make_{app}_hooks")(num_layer)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["othello", "puzzle15"])
def test_graph_hooked_engine_equals_the_eager_step_on_card(card, app):
    """The apps' example hooks (othello's pair on RWKV-7, puzzle15's tap on
    RWKV-6) in the Engine's graphs, the default on the card, against
    ``graph=False``: B=4 on prompts of 300/77/40/9 tokens, generating twice
    and then a FULL chunk: tokens, state and logits bit for bit, launches
    by kernel and shape exact, and the hooked step on the per-layer path
    (no whole-stack, att-core or grouped launch)."""
    from web_rwkv_gguf_tpu_torch.runtime import Engine

    info, params = (_graph_model if app == "othello" else _graph_model_v6)(card)
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(0, 512, n)] for n in GRAPH_LENGTHS]
    runs = {}
    for graphed in (True, False):
        eng = Engine(info, params, 4, device=card, hooks=_example_hooks(app, info.num_layer),
                     graph=None if graphed else False)
        assert eng.graph == graphed
        runs[graphed] = _graph_traffic(eng, prompts)
        if graphed:
            assert any(k[0] == "segment" for k in eng._graphs.graphs)
    (got, got_n), (want, want_n) = runs[True], runs[False]
    assert got_n == want_n
    assert not {"layer_scan7", "layer_scan56", "att_core7_step", "quant_gemv_grouped"} & set(got_n)
    assert _same(got, want)


@pytest.mark.cuda
def test_graph_embedding_chunk_equals_the_eager_step_on_card(card):
    """Token::Embed lanes (ids; the same tokens as embedding rows; the two
    in turn; ids of another prompt; 40 tokens each, one T=64 chunk of 160
    tokens) through
    ``Engine.infer`` on the ``("embeds", 64)`` graph against ``graph=False``,
    twice from a reset state (the second call replays): logits and state
    bit for bit, launches by kernel and shape exact, one capture."""
    from web_rwkv_gguf_tpu_torch.runtime import Engine, RnnInput, RnnInputBatch, graph

    info, params = _graph_model(card)
    rng = np.random.default_rng(9)
    ids, other = ([int(t) for t in rng.integers(0, 512, 40)] for _ in range(2))
    rows = params["emb"][torch.tensor(ids, device=card)].float().cpu().numpy()
    lanes = [ids, list(rows), [t if i % 2 == 0 else rows[i] for i, t in enumerate(ids)], other]
    runs = {}
    for graphed in (True, False):
        eng = Engine(info, params, 4, device=card, graph=None if graphed else False)
        before = graph.launch_counts()
        out = []
        for _ in range(2):
            eng.reset_state()
            inp = RnnInput([RnnInputBatch(list(t)) for t in lanes], 160)
            while inp.num_token:
                out.append([o.copy() for o in eng.infer(inp).batches])
            out.append({k: v.clone() for k, v in eng.state.items()})
        torch.cuda.synchronize()
        runs[graphed] = out, graph.count_delta(before, graph.launch_counts())
        if graphed:
            assert list(eng._graphs.graphs) == [("embeds", 64)]
    (got, got_n), (want, want_n) = runs[True], runs[False]
    assert got_n == want_n
    assert _same(got, want)
    assert np.array_equal(got[0][0], got[0][1])  # the rows lane is the ids lane


@pytest.mark.cuda
def test_graph_refuses_a_hook_that_reads_the_host_on_card(card):
    """A hook that calls ``.item()`` cannot be captured: the graph Engine
    and the captured segment raise ``UnsupportedFeature`` naming
    ``graph=False``, the Engine's state as it was; ``graph=False`` runs it;
    and a graph Engine made after the failed capture still equals the
    eager step (the stream and the allocator put back)."""
    from web_rwkv_gguf_tpu_torch.errors import UnsupportedFeature
    from web_rwkv_gguf_tpu_torch.models import init_state, make_generator
    from web_rwkv_gguf_tpu_torch.runtime import Engine

    info, params = _graph_model(card)
    seen = []

    def reads_the_host(layer, x):
        seen.append(x.abs().max().item())

    hooks = {"pre_head": reads_the_host}
    prompts = [[3, 17, 40, 5], [9, 1, 25]]
    eng = Engine(info, params, 2, device=card, hooks=hooks)
    fresh = {k: v.clone() for k, v in eng.state.items()}
    with pytest.raises(UnsupportedFeature, match="graph=False"):
        eng.generate(prompts, 4)
    assert torch.cuda.current_stream(card) == torch.cuda.default_stream(card)
    assert _same({k: v.clone() for k, v in eng.state.items()}, fresh)
    with pytest.raises(UnsupportedFeature, match="graph=False"):
        make_generator(info, steps=2, hooks=hooks)(params, init_state(info, 2, device=card),
                                                   torch.tensor([[5], [9]], device=card))
    seen.clear()
    toks = Engine(info, params, 2, device=card, hooks=hooks, graph=False).generate(prompts, 4)
    assert [len(t) for t in toks] == [4, 4] and seen
    runs = [Engine(info, params, 2, device=card, graph=g).generate(prompts, 33)
            for g in (None, False)]
    assert runs[0] == runs[1]
