"""Token generation: N decode steps with sampling on the device.

Sampling (greedy / temperature / top-k / nucleus) runs on the logits'
device with a ``torch.Generator``, so a greedy segment never waits for
the host between steps.

Per-lane stop tokens: a lane that samples a stop id freezes — it runs
with length 0, so the padding mask keeps its recurrent state — and keeps
re-emitting the stop id; the caller trims the surplus. The returned
``done`` flags say which lanes have stopped.

On a CUDA device a segment is captured once as a CUDA graph and replayed
(``runtime/graph.py``), the counterpart of the JAX package's compiled
segment; hooks are captured with it, their Python bodies run at the
warm-up and the capture only (``models.forward.HookCtx``).
"""

from __future__ import annotations

import torch

from ..errors import UnsupportedFeature
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
    graph=None,
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
    mesh: ``runtime.Engine._mesh_step``).

    The whole segment is one CUDA graph (the JAX package's one compiled
    ``lax.scan``, ``done`` kept on the device), the hooks' taps in it:
    ``graph`` None captures where the token lies on a CUDA device and
    there is no ``step`` (a mesh Engine's, eager by rule), False runs every
    step eagerly (the reference), True captures on any device (on the CPU
    only with ``runtime.graph.CAPTURE`` replaced), and a
    ``runtime.graph.StepGraphs`` (an Engine's) captures into its pool and
    static state. A captured segment's state comes back as static
    buffers, updated in place by every call; a call's ``generator`` is
    advanced as the eager segment advances it. A segment whose hooks read
    the host raises ``UnsupportedFeature`` at its first captured call.
    The returned function's ``graphs`` is the ``StepGraphs`` of its last
    captured call (None before one)."""
    if graph is not None and graph is not False and step is not None:
        raise UnsupportedFeature("step= runs eagerly: a captured segment does not take it")
    sample = make_sampler(temperature, top_k, top_p)
    sampled = temperature > 0.0

    def segment(params, state, token, generator, stop):
        layers = None if step is not None else layer_params(params, info.num_layer)
        done = torch.isin(token[:, 0], stop)
        logits = torch.zeros(token.shape[0], info.num_vocab, device=token.device)
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
        return out, logits, state, done

    own = {}  # a standalone generator's graphs and its sampling generator

    def captured(params, state, token, generator):
        from ..runtime.graph import StepGraphs, commit  # runtime imports this module

        graphs = graph if isinstance(graph, StepGraphs) else own.get("graphs")
        if graphs is None:
            graphs = own["graphs"] = StepGraphs(state)
        run.graphs = graphs
        # the graph samples from a generator of its own, registered at
        # capture; a call's generator state is handed in and back out
        gen = own.get("gen")
        if sampled and gen is None:
            gen = own["gen"] = torch.Generator(device=graphs.device)
        if sampled and generator is not None:
            gen.set_state(generator.get_state())

        def make(static, st):
            stop = torch.tensor(stop_ids, dtype=torch.long, device=graphs.device)

            def fn():
                out, logits, new, done = segment(params, st, static["token"], gen, stop)
                commit(st, new)
                return out, logits, done
            return fn

        (out, logits, done), state = graphs.run(
            ("segment", id(own)), params, make, {"token": token.long()}, state,
            (gen,) if sampled else ())
        if sampled and generator is not None:
            generator.set_state(gen.get_state())
        return out, logits, state, generator, done

    def run(params, state, token, generator=None):
        if graph is False or (graph is None and (not token.is_cuda or step is not None)):
            stop = torch.tensor(stop_ids, dtype=torch.long, device=token.device)
            out, logits, state, done = segment(params, state, token.long(), generator, stop)
            return out, logits, state, generator, done
        return captured(params, state, token, generator)

    run.graphs = None
    return run
