"""Inference engine: chunked continuous batching over one loaded model.

The port of the JAX package's ``runtime/engine.Engine`` (ref:
src/runtime/mod.rs:84-219). The engine owns the recurrent state of
``num_batch`` lanes; ``infer`` runs one planned chunk per call
(``runtime/scheduler.py``) and ``generate`` prefills prompts, then decodes
all lanes in lockstep through ``models/generate.make_generator``.

PyTorch runs eagerly, so there is no compile cache; chunk lengths are
still bucketed to powers of two exactly as the JAX package does, so each
chunk takes the same WKV route (the scan kernel below T = 128, the
chunk-parallel form from it) and each matmul the same numerics class.
Logits come back to the host as numpy arrays, as the JAX engine returns
them; ``generate`` keeps them on the device and fetches only token ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import EngineError, TensorError, UnsupportedFeature
from ..models.forward import forward_chunk, init_state, logits_head
from ..models.generate import make_generator, make_sampler
from ..models.info import ModelInfo, ModelVersion
from ..models.loader import prepare_decode
from .scheduler import RnnInput, RnnInputBatch, RnnOption


def _bucket(n: int, cap: int) -> int:
    """Round up to the next power of two (≤ cap); n itself above cap."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap) if cap >= n else n


@dataclass
class RnnOutput:
    """Per-batch logit rows: list of ``[n_out, vocab]`` f32 arrays (empty
    when a batch produced no logits this chunk)."""

    batches: list[np.ndarray]

    def __getitem__(self, i):
        return self.batches[i]

    def __len__(self):
        return len(self.batches)


def softmax(logits) -> np.ndarray:
    """Softmax over the last axis of a numpy array or tensor (ref:
    src/runtime/softmax.rs); returns numpy."""
    return torch.softmax(torch.as_tensor(logits).float(), dim=-1).cpu().numpy()


def _trim_stop(seqs: list[list[int]], max_tokens: int, stop_tokens: set[int]):
    trimmed = []
    for seq in seqs:
        seq = seq[:max_tokens]
        for i, t in enumerate(seq):
            if t in stop_tokens:
                seq = seq[: i + 1]
                break
        trimmed.append(seq)
    return trimmed


class Engine:
    """Stateful batched inference over one loaded model (``params`` from
    ``models.load_model`` on ``device``)."""

    def __init__(
        self,
        info: ModelInfo,
        params,
        num_batch: int,
        *,
        token_chunk_size: int = 128,
        rescale: int | None = None,
        initial_wkv: np.ndarray | None = None,
        device="cuda",
    ):
        self.info = info
        # decode of up to MAX_SCAN_BATCH lanes runs as one whole-stack
        # kernel launch per token (ops/cuda/layer7), as the JAX engine's
        # default single-device prepare_decode arranges it
        self.params = prepare_decode(params, info, batch_hint=num_batch)
        self.num_batch = num_batch
        self.token_chunk_size = token_chunk_size
        self.rescale = rescale
        self.device = torch.device(device)
        # pretrained time_state: [L, H, K, V], broadcast over the lanes
        if initial_wkv is not None and info.version == ModelVersion.V4:
            raise UnsupportedFeature(
                "initial_wkv (pretrained time_state) needs a matrix-state model "
                "(V5/V6/V7); V4 carries per-channel (aa, bb, pp) state")
        self._initial_wkv = initial_wkv
        self.state = self._fresh_state()

    def _fresh_state(self) -> dict:
        state = init_state(self.info, self.num_batch, device=self.device)
        if self._initial_wkv is not None:
            wkv = torch.as_tensor(np.asarray(self._initial_wkv, np.float32),
                                  device=self.device)
            state["wkv"] = wkv[:, None].expand_as(state["wkv"]).clone()
        return state

    # -- state management (ref: State trait, src/runtime/model.rs:78-103) --

    def back_state(self, batch: int) -> dict:
        """One lane's recurrent state, copied to the host (numpy)."""
        return {k: a[:, batch].cpu().numpy() for k, a in self.state.items()}

    def load_state(self, batch: int, snapshot: dict):
        """Restore one lane's state from :meth:`back_state`."""
        for k, a in self.state.items():
            a[:, batch] = torch.as_tensor(np.asarray(snapshot[k]), device=a.device)

    def reset_state(self, batch: int | None = None):
        fresh = self._fresh_state()
        if batch is None:
            self.state = fresh
        else:
            for k, a in self.state.items():
                a[:, batch] = fresh[k][:, batch]

    # -- inference ---------------------------------------------------------

    def _empty(self) -> RnnOutput:
        return RnnOutput([np.zeros((0, self.info.num_vocab), np.float32)]
                         * self.num_batch)

    def _chunk_tokens(self, batches, plan) -> np.ndarray:
        """The planned tokens as ``[B, T]`` ids, T bucketed to a power of
        two (engine.py:476, :661 of the JAX package)."""
        T = _bucket(max(p.len for p in plan), self.token_chunk_size)
        tokens = np.zeros((self.num_batch, T), np.int64)
        for b, (batch, p) in enumerate(zip(batches, plan)):
            chunk = batch.tokens[: p.len]
            if not all(isinstance(t, (int, np.integer)) for t in chunk):
                raise UnsupportedFeature(
                    "embedding tokens (the reference's Token::Embed) belong to "
                    "the port's vision slice; pass token ids")
            tokens[b, : p.len] = chunk
        return tokens

    def _forward(self, tokens: np.ndarray, lens: list[int]):
        tok = torch.as_tensor(tokens, device=self.device)
        ln = torch.as_tensor(lens, dtype=torch.long, device=self.device)
        x, state = forward_chunk(self.info, self.params, self.state, tok, ln,
                                 rescale=self.rescale)
        return x, ln, state

    def _forward_last(self, tokens: np.ndarray, lens: list[int]):
        """The chunk's forward and each lane's last-token logits ``[B, V]``
        (on the device)."""
        x, ln, state = self._forward(tokens, lens)
        idx = torch.clamp(ln - 1, 0, x.shape[1] - 1)
        rows = x[torch.arange(x.shape[0], device=x.device), idx]
        return logits_head(self.params, rows), state

    def infer(self, input: RnnInput) -> RnnOutput:
        """Process one chunk of ``input`` (tokens are consumed in place).

        Mirrors ``Runtime::infer`` (ref: src/runtime/mod.rs:267-276): call
        repeatedly until every batch is drained; generation is driven by
        pushing sampled tokens back into the input lanes.
        """
        if len(input.batches) != self.num_batch:
            raise TensorError.batch(len(input.batches), self.num_batch)
        plan = input.plan()
        lens = [p.len for p in plan]
        if sum(lens) == 0:
            return self._empty()
        tokens = self._chunk_tokens(input.batches, plan)

        if all(p.option in (None, RnnOption.LAST) for p in plan):
            # one head call on every lane's last row; only the lanes that
            # finish their prompt this chunk are fetched
            logits, self.state = self._forward_last(tokens, lens)
            input.step(plan)
            active = [b for b, p in enumerate(plan)
                      if p.option == RnnOption.LAST and p.len > 0]
            host = logits[active].cpu().numpy()
            out = [np.zeros((0, self.info.num_vocab), np.float32)] * self.num_batch
            for i, b in enumerate(active):
                out[b] = host[i : i + 1]
            return RnnOutput(out)

        x, _, self.state = self._forward(tokens, lens)
        rows_b, rows_t, counts = [], [], []
        for b, p in enumerate(plan):
            if p.option is None or p.len == 0:
                counts.append(0)
            elif p.option == RnnOption.LAST:
                rows_b.append(b)
                rows_t.append(p.len - 1)
                counts.append(1)
            else:  # FULL
                rows_b.extend([b] * p.len)
                rows_t.extend(range(p.len))
                counts.append(p.len)
        input.step(plan)
        if not rows_b:
            return self._empty()

        # the head runs on a power-of-two row count (engine.py:604-611)
        n = len(rows_b)
        npad = _bucket(n, 1 << 30)
        bi = torch.zeros(npad, dtype=torch.long)
        ti = torch.zeros(npad, dtype=torch.long)
        bi[:n] = torch.tensor(rows_b)
        ti[:n] = torch.tensor(rows_t)
        rows = x[bi.to(x.device), ti.to(x.device)]
        logits = logits_head(self.params, rows)[:n].cpu().numpy()
        out, off = [], 0
        for c in counts:
            out.append(logits[off : off + c])
            off += c
        return RnnOutput(out)

    # -- generation --------------------------------------------------------

    def _gen_prefill(self, prompts, temperature, top_k, top_p, seed):
        """Prefill the prompts, keeping the logits on the device, and sample
        the first generated token with the generator's own sampler.
        Returns ``(first [B, 1], generator)``, both on the device."""
        if len(prompts) != self.num_batch:
            raise TensorError.batch(len(prompts), self.num_batch)
        if any(len(p) == 0 for p in prompts):
            raise EngineError(
                "generate() requires a non-empty prompt per lane "
                "(there are no logits to sample the first token from)")
        inp = RnnInput([RnnInputBatch(list(p)) for p in prompts],
                       self.token_chunk_size)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        logits = None
        while inp.num_token:
            plan = inp.plan()
            lens = [p.len for p in plan]
            if sum(lens) == 0:
                break
            lg, self.state = self._forward_last(self._chunk_tokens(inp.batches, plan),
                                                lens)
            ran = torch.tensor([p.len > 0 for p in plan], device=self.device)
            logits = lg if logits is None else torch.where(ran[:, None], lg, logits)
            inp.step(plan)
        sample = make_sampler(temperature, top_k, top_p)
        return sample(logits, generator)[:, None], generator

    def generate(
        self,
        prompts: list[list[int]],
        max_tokens: int,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        stop_tokens: set[int] | None = None,
        seed: int = 0,
        segment: int = 32,
    ) -> list[list[int]]:
        """Prefill, then decode ``segment`` tokens per generator call with
        sampling on the device. Lanes decode in lockstep; a lane that
        samples a stop token freezes (its state stops advancing) and the
        loop ends once every lane has stopped; surplus tokens are trimmed.
        Tokens stay on the device until the end."""
        first, generator = self._gen_prefill(prompts, temperature, top_k, top_p,
                                             seed)
        stop_tokens = stop_tokens or set()
        run = make_generator(self.info, steps=segment, temperature=temperature,
                             top_k=top_k, top_p=top_p, rescale=self.rescale,
                             stop_ids=tuple(sorted(stop_tokens)))
        token, segs, produced = first, [], 1
        while produced < max_tokens:
            toks, _, self.state, generator, done = run(self.params, self.state,
                                                       token, generator)
            segs.append(toks)
            produced += segment
            token = toks[:, -1:]
            if stop_tokens and bool(done.all()):
                break  # every lane froze on its stop token
        results = [[t] for t in first[:, 0].tolist()]
        if segs:
            for b, row in enumerate(torch.cat(segs, dim=1).tolist()):
                results[b].extend(row)
        return _trim_stop(results, max_tokens, stop_tokens)
