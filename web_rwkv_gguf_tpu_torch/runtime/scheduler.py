"""Chunk scheduler: fair min-fill token planning + output redirection.

The port's own copy of the JAX package's numpy-only scheduler (the JAX
package's ``runtime`` cannot be imported without JAX), itself a
re-derivation of the reference's pure scheduling logic (ref:
src/runtime/infer/rnn.rs:41-134, 283-334). The planner splits
arbitrarily long multi-batch inputs into chunks of at most
``token_chunk_size`` tokens, filling batches fairly (repeatedly granting
each non-empty batch up to the smallest remaining count), and the
redirect computes which token positions produce logits.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


MIN_TOKEN_CHUNK_SIZE = 32  # ref: rnn.rs:10


class RnnOption(enum.Enum):
    LAST = "last"  # only the prediction for the final token
    FULL = "full"  # predictions for every token


@dataclass
class RnnInputBatch:
    """One sequence lane. ``tokens`` may contain ints (token ids) or
    numpy arrays (pre-computed embeddings, the reference's
    ``Token::Embed``)."""

    tokens: list = field(default_factory=list)
    option: RnnOption = RnnOption.LAST

    def push(self, token):
        self.tokens.append(token)

    def append(self, tokens):
        self.tokens.extend(tokens)

    def replace(self, tokens):
        old, self.tokens = self.tokens, list(tokens)
        return old


@dataclass
class PlanBatch:
    len: int
    option: RnnOption | None  # None → no logits for this batch this chunk


@dataclass
class Redirect:
    """Maps chunk-stacked token positions to output logit rows
    (ref: rnn.rs:41-99)."""

    headers: list[int]  # stacked-token indices that produce logits
    inputs: list[tuple[int, int]]  # batch → stacked-token range
    outputs: list[tuple[int, int]]  # batch → logit-row range


class RnnInput:
    """Batched input task; mirrors the reference API (ref: rnn.rs:196-254)."""

    def __init__(self, batches: list[RnnInputBatch], token_chunk_size: int = 128):
        size = max(token_chunk_size, MIN_TOKEN_CHUNK_SIZE)
        size = -(-size // MIN_TOKEN_CHUNK_SIZE) * MIN_TOKEN_CHUNK_SIZE
        self.batches = batches
        self.token_chunk_size = size

    @property
    def num_token(self) -> int:
        return sum(len(b.tokens) for b in self.batches)

    def plan(self) -> list[PlanBatch]:
        return plan_chunk(
            [len(b.tokens) for b in self.batches],
            [b.option for b in self.batches],
            self.token_chunk_size,
        )

    def step(self, plan: list[PlanBatch] | None = None):
        """Consume the planned tokens (ref: rnn.rs:233-240)."""
        plan = plan or self.plan()
        for batch, p in zip(self.batches, plan):
            batch.tokens = batch.tokens[p.len :]

    def chunk(self, plan: list[PlanBatch] | None = None) -> list[list]:
        plan = plan or self.plan()
        return [b.tokens[: p.len] for b, p in zip(self.batches, plan)]


def _fair_fill(remains: list[int], token_chunk_size: int) -> list[int]:
    """Fair min-fill of one chunk (ref: rnn.rs:283-334): repeatedly grant
    every still-reading lane up to the smallest positive remainder until
    the (MIN_TOKEN_CHUNK_SIZE-aligned) budget is spent. MUTATES
    ``remains`` to the post-chunk remainders and returns per-lane takes."""
    num_token = min(sum(remains), token_chunk_size)
    if num_token > MIN_TOKEN_CHUNK_SIZE:
        num_token -= num_token % MIN_TOKEN_CHUNK_SIZE

    lens = [0] * len(remains)
    while num_token > 0:
        positive = [r for r in remains if r > 0]
        if not positive:
            break
        mid = min(positive)
        for i, r in enumerate(remains):
            if r == 0:
                continue
            take = min(mid, num_token)
            num_token -= take
            lens[i] += take
            remains[i] -= take
    return lens


def _plan_option(opt: RnnOption, rem: int) -> RnnOption | None:
    """Logit option for a planned lane: FULL always emits; LAST emits
    only when the prompt finishes this chunk."""
    if opt == RnnOption.FULL:
        return RnnOption.FULL
    if opt == RnnOption.LAST and rem == 0:
        return RnnOption.LAST
    return None


def plan_chunk(
    remains: list[int], options: list[RnnOption], token_chunk_size: int
) -> list[PlanBatch]:
    """Fair min-fill planning of one chunk (ref: rnn.rs:283-334).

    Sequences still reading (len remaining after this chunk > 0) emit no
    logits under LAST; a batch that finishes its prompt this chunk gets
    its LAST logit; FULL batches always emit logits for planned tokens.
    A fresh zero-length batch plans zero tokens (the "Gen" 1-token lane
    only appears in multi-step lookahead, see :class:`RnnIter`).
    """
    remains = list(remains)
    lens = _fair_fill(remains, token_chunk_size)
    return [
        PlanBatch(ln, _plan_option(opt, rem))
        for ln, opt, rem in zip(lens, options, remains)
    ]


class RnnIter:
    """Multi-step chunk-plan lookahead (ref: rnn.rs:274-335).

    After a batch's prompt is exhausted within the iteration, it becomes a
    1-token generation lane ("Gen") in subsequent plans — this is what the
    reference's speculative pipeline uses to pre-build future jobs.
    """

    def __init__(self, input: RnnInput):
        self._states: list[tuple[str, int]] = [
            ("read", len(b.tokens)) for b in input.batches
        ]
        self._options = [b.option for b in input.batches]
        self._chunk = input.token_chunk_size

    def __iter__(self):
        return self

    def __next__(self) -> list[PlanBatch]:
        remains = [1 if kind == "gen" else n for kind, n in self._states]
        lens = _fair_fill(remains, self._chunk)
        out = []
        for i, (ln, opt, rem) in enumerate(zip(lens, self._options, remains)):
            if ln > 0:
                self._states[i] = ("gen", 1) if rem == 0 else ("read", rem)
            out.append(PlanBatch(ln, _plan_option(opt, rem)))
        return out


def redirect(plan: list[PlanBatch]) -> Redirect:
    """Compute logit-producing positions for a chunk plan (ref: rnn.rs:41-99)."""
    headers: list[int] = []
    inputs: list[tuple[int, int]] = []
    outputs: list[tuple[int, int]] = []
    p_in = p_out = 0
    for info in plan:
        ln = info.len
        if info.option is None:
            inputs.append((p_in, p_in + ln))
            outputs.append((p_out, p_out))
            p_in += ln
        elif info.option == RnnOption.LAST:
            inputs.append((p_in, p_in + ln))
            if ln == 0:
                outputs.append((p_out, p_out))
            else:
                outputs.append((p_out, p_out + 1))
                headers.append(p_in + ln - 1)
                p_out += 1
            p_in += ln
        else:  # FULL
            inputs.append((p_in, p_in + ln))
            outputs.append((p_out, p_out + ln))
            headers.extend(range(p_in, p_in + ln))
            p_out += ln
            p_in += ln
    return Redirect(headers, inputs, outputs)
