"""Token generation: N decode steps with sampling on the device.

Sampling (greedy / temperature / top-k / nucleus) runs on the logits'
device with a ``torch.Generator``, so a greedy segment never waits for
the host between steps.

Per-lane stop tokens: a lane that samples a stop id freezes — it runs
with length 0, so the padding mask keeps its recurrent state — and keeps
re-emitting the stop id; the caller trims the surplus. The returned
``done`` flags say which lanes have stopped.
"""

from __future__ import annotations

import torch

from .forward import _forward, logits_head
from .info import ModelInfo
from .loader import layer_params


def make_sampler(
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    top_p_candidates: int = 128,
):
    """Build a ``(logits [B, V], generator) -> token [B]`` sampler.

    Greedy at ``temperature <= 0``. ``top_p`` in (0, 1) keeps every token
    whose preceding cumulative probability (at temperature 1, over the
    ``top_p_candidates`` highest logits) is at most ``top_p``, the
    crossing token included, then samples the kept set at
    ``temperature``. ``top_k > 0`` keeps the k highest logits. The
    generator must live on the logits' device."""

    def sample(logits: torch.Tensor, generator: torch.Generator | None):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        if 0.0 < top_p < 1.0:
            cand = top_p_candidates
            if top_k > 0:
                cand = min(cand, top_k)
            cand = min(cand, logits.shape[-1])
            vals, idx = torch.topk(logits, cand, dim=-1)  # descending
            probs = torch.softmax(vals, dim=-1)
            prev = torch.cumsum(probs, dim=-1) - probs  # preceding mass
            scaled = torch.where(prev <= top_p, vals / temperature, -torch.inf)
            choice = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                       generator=generator)
            return torch.gather(idx, -1, choice)[:, 0]
        scaled = logits / temperature
        if 0 < top_k < logits.shape[-1]:
            kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, -torch.inf, scaled)
        return torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                 generator=generator)[:, 0]

    return sample


def make_generator(
    info: ModelInfo,
    *,
    steps: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    rescale: int | None = None,
    stop_ids: tuple[int, ...] = (),
    hooks: dict | None = None,
    step=None,
):
    """Build ``(params, state, token [B, 1], generator=None) ->
    (tokens [B, steps], logits [B, V], state, generator, done [B])`` that
    decodes ``steps`` tokens, each through ``forward_chunk`` at T=1 and
    ``logits_head``. Lanes that emit a token in ``stop_ids`` freeze
    (state kept, stop id re-emitted); ``done`` reports which lanes have
    stopped by the end. ``logits`` are the last step's. ``hooks`` tap
    every step's forward and head (the JAX package's generator takes none,
    so its ``Engine.generate`` decodes a hooked engine unhooked).
    ``step(params, state, token [B, 1], lens [B]) -> (logits [B, V],
    state)`` replaces the forward and head of a step (the Engine's under a
    mesh: ``runtime.Engine._mesh_step``)."""
    sample = make_sampler(temperature, top_k, top_p)

    def run(params, state, token, generator=None):
        layers = None if step is not None else layer_params(params, info.num_layer)
        device = token.device
        stop = torch.tensor(stop_ids, dtype=torch.long, device=device)
        token = token.long()
        done = torch.isin(token[:, 0], stop)
        logits = torch.zeros(token.shape[0], info.num_vocab, device=device)
        toks = []
        for _ in range(steps):
            # done lanes run with length 0: the padding mask freezes them
            lens = torch.where(done, 0, 1)
            if step is not None:
                logits, state = step(params, state, token, lens)
            else:
                x, state = _forward(info, params, layers, state, token, lens,
                                    rescale, hooks)
                logits = logits_head(params, x[:, 0], hooks=hooks)
            nxt = torch.where(done, token[:, 0], sample(logits, generator))
            done = done | torch.isin(nxt, stop)
            token = nxt[:, None]
            toks.append(nxt)
        out = torch.stack(toks, dim=1) if toks else token[:, :0]
        return out, logits, state, generator, done

    return run
