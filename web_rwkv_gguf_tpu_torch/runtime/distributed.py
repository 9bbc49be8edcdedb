"""Continuous batching across processes: the chunk plan agreed by every
rank.

The port of the JAX package's ``runtime/distributed.py``. Every rank must
run the same forward with the same shapes at each step, so the
coordinator (global rank 0):

1. accepts requests (the only rank that needs real token queues),
2. plans the chunk (lengths, output options, the token block) there,
3. broadcasts an in-band control header and the token (or embedding)
   block to every rank of the world group,
4. and every rank derives the output rows from the header alone and runs
   the same step through its :class:`~.engine.Engine` (on a mesh: its
   shard, with the mesh's collectives).

Workers call :meth:`DistributedEngine.serve`; the header carries an
opcode, so they stop when the coordinator broadcasts :data:`OP_STOP`
(:meth:`DistributedEngine.shutdown`). A lane swapped mid-stream is marked
with :meth:`DistributedEngine.reset_lane` and its reset rides the same
header (ref: src/runtime/infer/rnn.rs:283-334). Without a process group
of two or more the broadcast is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import EngineError
from ..models.info import ModelInfo
from ..parallel.sharding import broadcast, world
from .engine import Engine, RnnOutput, _bucket, _split_rows
from .scheduler import RnnInput, RnnOption

OP_STEP = 0
OP_STOP = 1

_OPT_CODE = {None: 0, RnnOption.LAST: 1, RnnOption.FULL: 2}


def _broadcast(arr, device) -> np.ndarray | torch.Tensor:
    """Rank 0's ``arr`` (numpy, or a tensor) on every rank; the identity on
    one process."""
    if isinstance(arr, np.ndarray):
        return broadcast(torch.from_numpy(arr), 0, device=device).numpy()
    return broadcast(arr, 0, device=device)


def _redirect_rows(lens: np.ndarray, options: np.ndarray, T: int):
    """The output rows from header data alone, the same on every rank (ref:
    RnnInfo::redirect, src/runtime/infer/rnn.rs:41-99): ``(rows_b, rows_t,
    counts)``."""
    rows_b, rows_t, counts = [], [], []
    for b, (ln, opt) in enumerate(zip(lens, options)):
        ln = int(ln)
        if opt == 0 or ln == 0:
            counts.append(0)
        elif opt == 1:  # LAST
            rows_b.append(b)
            rows_t.append(ln - 1)
            counts.append(1)
        else:  # FULL
            rows_b.extend([b] * ln)
            rows_t.extend(range(ln))
            counts.append(ln)
    return rows_b, rows_t, counts


class DistributedEngine:
    """An Engine whose chunk plans are agreed across processes.

    Every rank builds it with the same arguments. ``mesh`` (a
    ``parallel.Mesh``) and ``tp_mode`` place the weights and state as
    ``Engine(mesh=, tp_mode=)`` does; without a mesh every rank runs the
    whole model. The forward is the Engine's per-layer one (no dense
    copies, no whole-stack blocks), as the JAX package's runs
    ``forward_chunk`` on the params given."""

    def __init__(self, info: ModelInfo, params, num_batch: int, *, mesh=None,
                 token_chunk_size: int = 128, tp_mode: str = "gspmd", device="cuda"):
        if tp_mode not in ("gspmd", "shard_map"):
            raise EngineError(f"unknown tp_mode {tp_mode!r}")
        if tp_mode == "shard_map" and mesh is None:
            raise EngineError("tp_mode='shard_map' requires a mesh")
        self.info = info
        self.num_batch = num_batch
        self.token_chunk_size = token_chunk_size
        self.engine = Engine(info, params, num_batch, token_chunk_size=token_chunk_size,
                             mesh=mesh, tp_mode=tp_mode, unroll=False, prefill_dense=False,
                             decode_dense=False, device=device)
        self.params = self.engine.params
        self.is_coordinator = world()[0] == 0
        self._pending_reset = np.zeros(num_batch, bool)

    @property
    def state(self) -> dict:
        return self.engine.state

    # -- admission ---------------------------------------------------------

    def reset_lane(self, batch: int):
        """Mark a lane for state reset before the next chunk (coordinator
        only): a new sequence admitted into a drained lane."""
        self._pending_reset[batch] = True

    # -- coordinated stepping ----------------------------------------------

    def _header_size(self) -> int:
        return 3 + 3 * self.num_batch

    def infer(self, input: RnnInput) -> RnnOutput:
        """One coordinated chunk (the coordinator, with the live input);
        workers run :meth:`serve`."""
        if not self.is_coordinator:
            raise EngineError("only the coordinator (rank 0) calls infer; workers serve()")
        if len(input.batches) != self.num_batch:
            raise EngineError(f"{len(input.batches)} batches, engine has {self.num_batch}")
        plan = input.plan()
        lens = np.asarray([p.len for p in plan], np.int32)
        opts = np.asarray([_OPT_CODE[p.option] for p in plan], np.int32)
        T = _bucket(max(int(lens.max()), 1), self.token_chunk_size)
        has_embeds = any(not isinstance(t, (int, np.integer))
                         for batch, p in zip(input.batches, plan)
                         for t in batch.tokens[: p.len])
        header = np.concatenate([[OP_STEP, T, int(has_embeds)], lens, opts,
                                 self._pending_reset.astype(np.int32)]).astype(np.int32)
        out = self._step(header, input, plan)
        self._pending_reset[:] = False
        return out

    def shutdown(self):
        """Broadcast the in-band stop opcode, so that every worker's
        :meth:`serve` returns (coordinator only)."""
        header = np.zeros(self._header_size(), np.int32)
        header[0] = OP_STOP
        _broadcast(header, self.engine.device)

    def serve(self):
        """Worker loop: run coordinated chunks until the coordinator
        broadcasts stop. All control is in-band."""
        if self.is_coordinator:
            raise EngineError("the coordinator (rank 0) calls infer, not serve")
        while self._step(np.zeros(self._header_size(), np.int32), None, None) \
                is not StopIteration:
            pass

    def _step(self, header, input, plan):
        eng, B = self.engine, self.num_batch
        header = _broadcast(header, eng.device)
        if int(header[0]) == OP_STOP:
            return StopIteration
        T, has_embeds = int(header[1]), bool(header[2])
        lens = header[3 : 3 + B]
        options = header[3 + B : 3 + 2 * B]
        for b in np.flatnonzero(header[3 + 2 * B :]):
            eng.reset_state(int(b))
        empty = RnnOutput([np.zeros((0, self.info.num_vocab), np.float32)] * B)
        if lens.sum() == 0:
            return empty if self.is_coordinator else None

        if self.is_coordinator:
            chunk = eng._chunk_tokens(input.batches, plan)
        elif has_embeds:
            chunk = torch.zeros(B, T, self.info.num_emb, device=eng.device)
        else:
            chunk = np.zeros((B, T), np.int64)
        if has_embeds != isinstance(chunk, torch.Tensor) or chunk.shape[1] != T:
            raise EngineError("the planned chunk does not match its header")
        chunk = _broadcast(chunk, eng.device)
        x, _, eng.state, _ = eng._forward(chunk, [int(n) for n in lens])

        # output rows derived from the header on every rank, so every rank
        # runs the same head
        rows_b, rows_t, counts = _redirect_rows(lens, options, T)
        if self.is_coordinator:
            input.step(plan)
        if not rows_b:
            return empty if self.is_coordinator else None
        logits = eng._row_logits(x, rows_b, rows_t, counts)
        return _split_rows(logits, counts) if self.is_coordinator else None
