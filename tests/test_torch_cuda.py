"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Imports nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX). Without a card every
test here skips. Tolerances: the gemvs sum the same f32 terms in another
order, atol = 1e-4·max|y|; the attention core, atol = 1e-4.
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("m,k", [(768, 768), (256, 3072)])
def test_q4k_gemv_on_card(card, m, k, n):
    raw = _weights(m, k, ggml.quantize_q4_k, seed=m + k)
    arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
              for a in (repack.repack_q4_k(raw, m, k)[0], *repack.q4k_scale_factors(raw, m, k))]
    x = _x(n, k, n, card)
    before = mm.q4k_gemv.launches
    got = mm.q4k_gemv(x, *arrays)
    assert mm.q4k_gemv.launches == before + 1
    _close(got, mm.q4k_gemv_plain(x, *arrays), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_q6k_gemv_on_card(card, n):
    m, k = 1024, 768
    raw = _weights(m, k, ggml.quantize_q6_k, seed=n)
    arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
              for a in (repack.repack_q6_k(raw, m, k)[0], *repack.q6k_scale_factors(raw, m, k))]
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
@pytest.mark.parametrize("B", [1, 3])
def test_att_core7_on_card(card, B):
    H, K = 12, 64
    g = torch.Generator(device=card).manual_seed(B)
    f = lambda *s: torch.randn(*s, generator=g, device=card) * 0.5  # noqa: E731
    mask = torch.tensor([True, False, True][:B], device=card)
    args = (f(B, H, K, K), f(B, H, K), f(B, H, K), f(B, H, K), f(B, H, K), f(B, H, K),
            torch.sigmoid(f(B, H, K)), f(H, K), f(H, K), 1 + 0.1 * f(H, K),
            0.1 * f(H, K), f(H, K), mask, 64e-5, 1e-12)
    before = core.att_core7_step.launches
    y1, s1 = core.att_core7_step(*args)
    assert core.att_core7_step.launches == before + 1
    y0, s0 = core.att_core7_plain(*args)
    torch.testing.assert_close(s1, s0, rtol=0, atol=1e-4)
    torch.testing.assert_close(y1[mask], y0[mask], rtol=0, atol=1e-4)
    if B == 3:
        assert torch.equal(s1[1], args[0][1])  # the masked lane keeps its state


@pytest.mark.cuda
def test_forward_refuses_what_this_slice_does_not_run_on_the_card(card):
    """Prefill (T > 1) and a Q4_K matrix without whole 256-element
    super-blocks per row raise on the card instead of running plain code."""
    from web_rwkv_gguf_tpu_torch.errors import UnsupportedTensorType
    from web_rwkv_gguf_tpu_torch.gguf import GgufFile
    from web_rwkv_gguf_tpu_torch.models import forward_chunk, init_state, load_model
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    raw = make_v7_gguf(n_layer=1, n_emb=256, head_size=64, n_vocab=64, n_hidden=384,
                       quantize=ggml.GgmlDType.Q4_K, seed=3)
    info, params = load_model(GgufFile(raw), device=card)
    state = init_state(info, 1, device=card)
    with pytest.raises(NotImplementedError):
        forward_chunk(info, params, state, torch.tensor([[1, 2]], device=card),
                      torch.tensor([2], device=card))
    with pytest.raises(UnsupportedTensorType):  # ffn.value is [256, 384]
        forward_chunk(info, params, state, torch.tensor([[1]], device=card),
                      torch.tensor([1], device=card))
