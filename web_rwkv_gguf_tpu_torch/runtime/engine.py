"""Inference engine: chunked continuous batching over one loaded model.

The port of the JAX package's ``runtime/engine.Engine`` (ref:
src/runtime/mod.rs:84-219). The engine owns the recurrent state of
``num_batch`` lanes; ``infer`` runs one planned chunk per call
(``runtime/scheduler.py``) and ``generate`` prefills prompts, then decodes
all lanes in lockstep through ``models/generate.make_generator``.

Chunk lengths are bucketed to powers of two exactly as the JAX package
does, so each chunk takes the same WKV route (the scan kernel below
T = 128, the chunk-parallel form from it) and each matmul the same
numerics class. On a CUDA device each bucket's step is a CUDA graph, the
counterpart of the JAX engine's jitted, state-donating programs
(``runtime/graph.py``): the forward of every (params, T bucket), FULL or
all-LAST with the head, the forward of an embedding chunk (the JAX
engine's ``_forward_embeds``), and ``generate``'s decode segment per
sampling config (``_gen_cache``, as the JAX engine's), each captured at
its first call and replayed after it, hooks and all; ``engine.state``
then holds the graphs' static buffers, updated in place.
``Engine(graph=False)`` keeps the eager step, the reference the card
checks hold the graphs against. A mesh (the tensor-parallel, pipeline
and sequence-parallel Engines, ``DistributedEngine`` across ranks) runs
eagerly by rule: gloo's collectives go through the host, and one card
proves NCCL only at one rank. Logits come back to the host as numpy
arrays, as the JAX engine returns them; ``generate`` keeps them on the
device and fetches only token ids.

Dense weights, as the JAX engine arranges them: chunks of at least
``prefill_dense_min_t`` tokens may run on a dense bf16 copy of every
quantized matrix (``prefill_dense``), and an engine of
``DECODE_DENSE_MIN_B`` lanes or more may decode on dense bf16 weights
through the whole-stack kernels' dense slot (``decode_dense``), each by
default where the copy clearly fits in the card's memory
(:func:`auto_prefill_dense`, :func:`auto_decode_dense`). :class:`EnginePool`
serves more lanes than one whole-stack launch takes as several engines
over one shared set of weights.

``Engine(hooks=)`` taps every forward and head, ``generate``'s decode
steps included, and leaves the whole-stack kernels (``forward_chunk``);
on a graph engine the taps run when a step is warmed up and captured,
and only their device work replays (``models.forward.HookCtx``: a hook
that reads the host needs ``graph=False``). A lane's token may be a
``[C]`` embedding vector (the reference's ``Token::Embed``), and a chunk
holding one runs as ``input_embeds``.

``Engine(mesh=, tp_mode=)`` serves across the ranks of a
``parallel.Mesh`` (the JAX package's engine.py:147-163, 215-284,
377-395): every rank builds the same engine and calls it with the same
input; the weights are placed by ``tp_mode`` (``parallel/tensor.py``),
the state by ``parallel.shard_state`` (lanes on ``data``, heads on
``model``), and ``infer`` returns the whole ``RnnOutput`` on every rank.
Under a mesh there is no dense copy, no unrolling and no whole-stack
block: decode runs the per-layer kernels.

More layouts over the mesh's ``model`` axis (the JAX package's
engine.py:331-371, 489-578):

- ``pipeline_microbatches=M``: the ranks of ``model`` are pipeline
  stages (``parallel/pipeline.py``). A rank holds its stage's ``L / S``
  layers of the weights and of its lanes' state, and the embedding and
  head whole; every chunk, ``generate``'s decode steps included, runs
  through the pipeline as M microbatches of the rank's lanes.
- ``seq_parallel=True``: chunks of at least ``seq_parallel_min_t``
  tokens whose lanes are all full and whose T divides by the ``model``
  ranks × 16 run as the sequence-parallel prefill
  (``parallel/sequence.py``), each rank a block of the tokens. The
  weights are whole on every rank and the state is replicated over
  ``model``, so every other chunk runs the per-layer forward on them,
  each rank of ``model`` the same lanes.
- both: the weights are whole on every rank and the state is the
  pipeline's. A chunk that qualifies runs the sequence-parallel prefill
  on the stages' state gathered into every layer, and each rank keeps
  its stage's layers of the result; every other chunk runs through the
  pipeline on views of the stage's layers (the JAX Engine's routing).

Both take ``tp_mode`` and ignore it for the weights (the JAX Engine
hands its tensor-parallel params to either and computes the same);
neither takes hooks. ``rescale`` holds on both (the JAX Engine drops it
there: ROADMAP, reference faults).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import EngineError, TensorError, UnsupportedFeature
from ..models.forward import forward_chunk, init_state, logits_head
from ..models.generate import make_generator, make_sampler
from ..models.info import ModelInfo, ModelVersion
from ..models.loader import dense_cache_bytes, densify_matrices, prepare_decode
from ..ops.cuda.layer7 import MAX_SCAN_BATCH
from ..ops.wkv_chunked import CHUNK
from ..parallel.pipeline import run_pipeline, stage_layers, stage_params
from ..parallel.sequence import make_seq_parallel_prefill
from ..parallel.sharding import all_gather, data_sharding, gather_state, shard_heads
from ..parallel.tensor import TP_MODES, LocalParams, place_params, tp_head
from .graph import StepGraphs, commit, new_pool
from .scheduler import RnnInput, RnnInputBatch, RnnOption


def memory_limit(device) -> int | None:
    """The bytes of memory of ``device`` that the dense policies weigh
    against: the card's total (``torch.cuda.mem_get_info``); None on the
    CPU, where the JAX package reads no memory limit either."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def auto_prefill_dense(extra_bytes: int, limit: int | None) -> bool:
    """Default of ``Engine(prefill_dense=None)``: cache dense bf16 prefill
    weights when the extra memory clearly fits (the JAX package's fit
    rule: 2.3 × the extra bytes below 0.6 of the limit); never with no
    known limit or nothing quantized."""
    return bool(limit) and extra_bytes > 0 and 2.3 * extra_bytes < 0.6 * limit


# The smallest batch at which Engine(decode_dense=None) decodes on dense
# bf16 weights: the JAX package's default. This card's own crossover
# between the whole-stack kernels' dense and quantized slots is in PERF.md.
DECODE_DENSE_MIN_B = 8


def auto_decode_dense(num_batch: int, extra_bytes: int, limit: int | None) -> bool:
    """Default of ``Engine(decode_dense=None)``: decode on dense bf16
    weights (the whole-stack kernels' dense slot; the quantized params
    kept as the cold copy) from ``DECODE_DENSE_MIN_B`` lanes on, where the
    dense copy clearly fits (:func:`auto_prefill_dense`'s rule). Accuracy
    class: weights rounded to bf16, as the reference's f16 dequantization
    at load (ref: gguf.rs:1785)."""
    return num_batch >= DECODE_DENSE_MIN_B and auto_prefill_dense(extra_bytes, limit)


def _dense_weights(params: dict, num_batch: int, decode_dense, prefill_dense, limit):
    """The Engine's dense arrangement of ``params`` (the JAX Engine's):
    ``(params to serve, the quantized cold copy or None, the dense prefill
    copy or None)``.

    ``decode_dense=None`` decodes on dense weights where
    :func:`auto_decode_dense` says so, the batch fits one whole-stack launch
    and the blocks are stacked, and never where whole-stack blocks are
    attached already: prepared params keep their decode form. The cold copy
    is kept only where the params hold a quantized matrix. Dense decode
    needs no separate prefill copy; otherwise ``prefill_dense=None`` makes
    one where :func:`auto_prefill_dense` says so."""
    extra = dense_cache_bytes(params)
    if decode_dense is None:
        decode_dense = (num_batch <= MAX_SCAN_BATCH
                        and not isinstance(params.get("blocks"), list)
                        and not {"mega7", "mega56"} & set(params)
                        and auto_decode_dense(num_batch, extra, limit))
    if decode_dense:
        return densify_matrices(params), (params if extra else None), None
    if prefill_dense is None:
        prefill_dense = auto_prefill_dense(extra, limit)
    return params, None, (densify_matrices(params) if prefill_dense else None)


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


def _split_rows(logits: np.ndarray, counts: list[int]) -> RnnOutput:
    """``logits`` ``[Σ counts, V]`` cut into each lane's rows."""
    out, off = [], 0
    for c in counts:
        out.append(logits[off : off + c])
        off += c
    return RnnOutput(out)


# the weights of a mesh Engine by its options: a tensor-parallel plan
# (``tp_mode``), a pipeline stage's layers, or the whole model on every rank
# (sequence parallelism, alone or beside the pipeline)
PIPELINE, SEQUENCE, PIPELINE_SEQUENCE = "pipeline", "sequence", "pipeline+sequence"


def _mesh_plan(mesh, tp_mode, seq_parallel, pipeline_microbatches, num_batch, hooks) -> str:
    """The placement of an Engine's weights under ``mesh`` (None without
    one); raises for options it does not take, with the JAX Engine's errors
    for the JAX Engine's bad cases (engine.py:331-371 of the JAX package).
    ``tp_mode`` places the weights of a plain mesh Engine only: a pipeline
    Engine holds its stage's layers, a sequence-parallel one (with the
    pipeline or without) the whole model (each computes what the JAX
    Engine computes with either ``tp_mode``, tests/test_torch_pipeline.py)."""
    if tp_mode not in TP_MODES:
        raise EngineError(f"unknown tp_mode {tp_mode!r}")
    for on, what in ((seq_parallel, "seq_parallel"),
                     (pipeline_microbatches, "pipeline_microbatches")):
        if on and mesh is None:
            raise EngineError(f"{what} requires a mesh")
        if on and hooks:
            raise UnsupportedFeature(f"hooks are not supported on the {what} path")
    if pipeline_microbatches:
        if num_batch % pipeline_microbatches:
            raise EngineError("num_batch must divide by microbatches")
        lanes = data_sharding(mesh, num_batch)
        if (lanes.stop - lanes.start) % pipeline_microbatches:
            raise EngineError("a data rank's lanes must divide by microbatches")
        return PIPELINE_SEQUENCE if seq_parallel else PIPELINE
    if mesh is None:
        return None
    return SEQUENCE if seq_parallel else tp_mode


def _placed(params, mesh, info, plan) -> LocalParams:
    """This rank's weights under ``plan`` (:func:`_mesh_plan`): ``params``
    as they are where they were placed on ``mesh`` by that plan already (as
    an ``EnginePool`` shares them), else placed now: the tensor-parallel
    plans by ``parallel.tensor.place_params``, a pipeline stage's layers by
    ``parallel.pipeline.stage_params``, a sequence-parallel Engine's
    whole model without the whole-stack blocks (its pipeline, where it has
    one, runs on views of the stage's layers)."""
    if isinstance(params, LocalParams):
        if params.mesh is not mesh or params.plan != plan:
            raise EngineError(f"params were placed for {params.plan!r} on another "
                              f"mesh or plan than {plan!r}")
        return params
    if plan in TP_MODES:
        return place_params(params, mesh, info, plan)
    if plan == PIPELINE:
        out = LocalParams(stage_params(params, info, mesh))
    else:
        out = LocalParams({k: v for k, v in params.items() if k not in ("mega7", "mega56")})
    out.mesh, out.plan, out.info, out.head_sharded = mesh, plan, info, False
    return out


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
    ``models.load_model`` on ``device``). With ``mesh=`` (a
    ``parallel.Mesh``) the engine serves this rank's shard of the lanes
    and weights on the mesh's device, ``tp_mode`` choosing the plan (see
    the module docstring); ``params`` may then also be placed already
    (``parallel.shard_params`` / ``shard_params_tp`` on the same mesh, or
    an ``EnginePool``'s). ``seq_parallel=True`` runs chunks of at least
    ``seq_parallel_min_t`` tokens, every lane full, through the
    sequence-parallel prefill (``parallel/sequence.py``);
    ``pipeline_microbatches=M`` runs every chunk, decode included, through
    the GPipe layer pipeline (``parallel/pipeline.py``), lane ``m·B/M +
    b`` as microbatch m's slot b. ``graph``: None replays each step as a
    CUDA graph on a CUDA device without a mesh, hooks and embedding chunks
    included (the module docstring), False runs every step eagerly (the
    reference), True captures on any device (on the CPU only with
    ``runtime.graph.CAPTURE`` replaced, as the tests do) and refuses a
    mesh. A step that cannot be captured (a hook that reads the host)
    raises ``UnsupportedFeature`` at its first call; it never falls back
    to the eager step."""

    def __init__(
        self,
        info: ModelInfo,
        params,
        num_batch: int,
        *,
        token_chunk_size: int = 128,
        rescale: int | None = None,
        initial_wkv: np.ndarray | None = None,
        prefill_dense: bool | None = None,
        prefill_dense_min_t: int = 64,
        decode_dense: bool | None = None,
        unroll: bool | None = None,
        hooks: dict | None = None,
        mesh=None,
        tp_mode: str = "gspmd",
        seq_parallel: bool = False,
        seq_parallel_min_t: int = 64,
        pipeline_microbatches: int | None = None,
        graph: bool | None = None,
        device="cuda",
    ):
        self.plan = _mesh_plan(mesh, tp_mode, seq_parallel, pipeline_microbatches, num_batch,
                               hooks)
        self.info = info
        self.mesh = mesh
        self._spf = self._pp_m = None
        if mesh is not None:
            # this rank's weights and lanes; no dense copy, no unrolling and
            # no whole-stack blocks (the JAX engine's mesh path)
            self.device = mesh.device
            self._lanes = data_sharding(mesh, num_batch)
            self.params = _placed(params, mesh, info, self.plan)
            self._info_fwd = self.params.info
            self.params_quantized = self._params_prefill = None
            if pipeline_microbatches:
                self._pp_m = pipeline_microbatches
                self._stage = stage_layers(info, mesh)
            if seq_parallel:
                self._spf = make_seq_parallel_prefill(info, mesh, rescale=rescale)
                self._sp_min_t = seq_parallel_min_t
        else:
            self.device = torch.device(device)
            self._lanes, self._info_fwd = slice(0, num_batch), info
            # dense bf16 weights for decode, or a dense copy for the chunks
            # of at least prefill_dense_min_t tokens (_dense_weights)
            params, self.params_quantized, self._params_prefill = _dense_weights(
                params, num_batch, decode_dense, prefill_dense, memory_limit(self.device))
            # decode of up to MAX_SCAN_BATCH lanes runs as one whole-stack
            # kernel launch per token (ops/cuda/layer7), as the JAX engine's
            # default single-device prepare_decode arranges it; unroll=False
            # keeps the params as given
            self.params = params if unroll is False else prepare_decode(
                params, info, batch_hint=num_batch)
        self._prefill_min_t = prefill_dense_min_t
        self.num_batch = num_batch
        self.token_chunk_size = token_chunk_size
        self.rescale = rescale
        # pretrained time_state: [L, H, K, V], broadcast over the lanes
        if initial_wkv is not None and info.version == ModelVersion.V4:
            raise UnsupportedFeature(
                "initial_wkv (pretrained time_state) needs a matrix-state model "
                "(V5/V6/V7); V4 carries per-channel (aa, bb, pp) state")
        self._initial_wkv = initial_wkv
        # model-structure taps on every forward and head, decode steps of
        # generate() included (the reference's Bundle::new_with_hooks; the
        # othello and puzzle15 examples); hooks leave the whole-stack
        # kernels, which the params keep for an unhooked call
        self.hooks = hooks
        self.state = self._fresh_state()
        # CUDA graphs of every step (runtime/graph.py), hooked ones included;
        # never under a mesh (gloo goes through the host, and one card proves
        # NCCL only at one rank)
        if graph is None:
            graph = self.device.type == "cuda" and mesh is None
        elif graph and mesh is not None:
            raise UnsupportedFeature("mesh plans run eagerly: graph=True takes no mesh")
        self.graph = graph
        self._graphs = None  # StepGraphs, made at the first captured step
        self._graph_pool = None  # a pool shared with other engines (EnginePool)
        self._graph_params = None  # the params objects the graphs were captured on
        self._gen_cache = {}  # generators by sampling config

    def _fresh_state(self) -> dict:
        """A fresh state of every lane; under a mesh this rank's shard."""
        device = "cpu" if self.mesh is not None else self.device
        state = init_state(self.info, self.num_batch, device=device)
        if self._initial_wkv is not None:
            wkv = torch.as_tensor(np.asarray(self._initial_wkv, np.float32), device=device)
            state["wkv"] = wkv[:, None].expand_as(state["wkv"]).clone()
        if self.mesh is None:
            return state
        return self._to_rank({k: a[:, self._lanes] for k, a in state.items()})

    def _to_rank(self, state: dict) -> dict:
        """A whole ``[L, b, ...]`` state of some of this rank's lanes as the
        rank holds it, on its device: a pipeline stage's layers, the
        sequence-parallel Engine's whole (replicated over ``model``), else
        its WKV heads (``parallel.sharding.shard_heads``)."""
        if self.plan in TP_MODES:
            return shard_heads(state, self.mesh)
        first, end = self._layers()
        return {k: a[first:end].to(self.device).contiguous() for k, a in state.items()}

    def _gather_state(self, part: dict) -> dict:
        """The inverse of :meth:`_to_rank` over the mesh: every layer of
        every data rank's lanes of ``part``, on every rank."""
        if self.plan in TP_MODES:
            return gather_state(part, self.mesh)
        if self._pp_m:
            part = self._all_layers(part)
        return {k: all_gather(self.mesh, "data", a, dim=1) for k, a in part.items()}

    def _layers(self) -> tuple[int, int]:
        """``(first, end)``: the global layers of the state this rank holds."""
        return self._stage if self._pp_m else (0, self.info.num_layer)

    def _all_layers(self, part: dict) -> dict:
        """A pipeline stage's layers of a state gathered into every layer,
        stage by stage over ``model``."""
        return {k: all_gather(self.mesh, "model", a, dim=0) for k, a in part.items()}

    # -- state management (ref: State trait, src/runtime/model.rs:78-103) --

    def _local_lane(self, batch: int) -> int | None:
        """This rank's index of lane ``batch``, None where another holds it."""
        lo, hi = self._lanes.start, self._lanes.stop
        return batch - lo if lo <= batch < hi else None

    def back_state(self, batch: int) -> dict:
        """One lane's recurrent state, copied to the host (numpy); under a
        mesh the whole lane, gathered from the ranks that hold it, on every
        rank."""
        if self.mesh is None:  # a copy: on the CPU .cpu() is the state itself
            return {k: a[:, batch].cpu().numpy().copy() for k, a in self.state.items()}
        b = self._local_lane(batch)
        # every data rank hands in its copy of the lane's slot (zeros where
        # it holds another lane); the owner's is taken
        part = {k: (a[:, b] if b is not None else torch.zeros_like(a[:, 0]))[:, None]
                for k, a in self.state.items()}
        whole = self._gather_state(part)
        owner = batch // (self._lanes.stop - self._lanes.start)
        return {k: a[:, owner].cpu().numpy().copy() for k, a in whole.items()}

    def load_state(self, batch: int, snapshot: dict):
        """Restore one lane's state from :meth:`back_state` (under a mesh,
        the rank that holds the lane keeps its part)."""
        if self.mesh is not None:
            b = self._local_lane(batch)
            if b is not None:
                part = self._to_rank({k: torch.as_tensor(np.asarray(v))[:, None]
                                      for k, v in snapshot.items()})
                for k, a in self.state.items():
                    a[:, b] = part[k][:, 0].to(a.device)
            return
        for k, a in self.state.items():
            a[:, batch] = torch.as_tensor(np.asarray(snapshot[k]), device=a.device)

    def reset_state(self, batch: int | None = None):
        fresh = self._fresh_state()
        if batch is None:
            self.state = fresh
            return
        b = batch if self.mesh is None else self._local_lane(batch)
        if b is not None:
            for k, a in self.state.items():
                a[:, b] = fresh[k][:, b]

    # -- inference ---------------------------------------------------------

    def _empty(self) -> RnnOutput:
        return RnnOutput([np.zeros((0, self.info.num_vocab), np.float32)]
                         * self.num_batch)

    def _chunk_tokens(self, batches, plan):
        """The planned tokens as ``[B, T]`` ids, T bucketed to a power of
        two (engine.py:476, :661 of the JAX package); where a lane holds an
        embedding vector (the reference's ``Token::Embed``), the chunk as
        ``[B, T, C]`` f32 embeddings on the engine's device instead: the
        ids' rows of ``params["emb"]`` beside the given vectors."""
        T = _bucket(max(p.len for p in plan), self.token_chunk_size)
        chunks = [batch.tokens[: p.len] for batch, p in zip(batches, plan)]
        if all(isinstance(t, (int, np.integer)) for c in chunks for t in c):
            tokens = np.zeros((self.num_batch, T), np.int64)
            for b, chunk in enumerate(chunks):
                tokens[b, : len(chunk)] = chunk
            return tokens
        at_ids, ids, at_vecs, vecs = [], [], [], []
        for b, chunk in enumerate(chunks):
            for t, tok in enumerate(chunk):
                if isinstance(tok, (int, np.integer)):
                    at_ids.append(b * T + t)
                    ids.append(int(tok))
                else:
                    vec = np.asarray(tok, np.float32).reshape(-1)
                    if vec.size != self.info.num_emb:
                        raise TensorError.size(vec.size, self.info.num_emb)
                    at_vecs.append(b * T + t)
                    vecs.append(vec)
        embeds = torch.zeros(self.num_batch * T, self.info.num_emb, device=self.device)
        if ids:
            rows = torch.tensor(ids, device=self.device)
            embeds[torch.tensor(at_ids, device=self.device)] = self.params["emb"][rows].float()
        embeds[torch.tensor(at_vecs, device=self.device)] = torch.from_numpy(
            np.stack(vecs)).to(self.device)
        return embeds.view(self.num_batch, T, -1)

    def _sp_ok(self, chunk, lens: list[int]) -> bool:
        """Whether a chunk takes the sequence-parallel prefill: no
        embeddings, at least ``seq_parallel_min_t`` tokens, T divisible by
        the ``model`` ranks × 16, and every lane full (the JAX Engine's
        rule, engine.py:489-497)."""
        T = chunk.shape[1]
        return (self._spf is not None and not isinstance(chunk, torch.Tensor)
                and T >= self._sp_min_t and T % (self.mesh.shape["model"] * CHUNK) == 0
                and all(n == T for n in lens))

    def _run(self, params, state, tokens, ln, embeds=None, sp=False):
        """The forward of this rank's lanes (ids ``[b, T]`` or ``embeds``
        ``[b, T, C]``, lengths ``ln`` ``[b]``) by the engine's plan:
        ``(x [b, T, C], new state)``. ``sp`` runs the sequence-parallel
        prefill, its x gathered over ``model`` (on a pipeline Engine, on
        the stages' state gathered into every layer, this stage's layers of
        the result kept); a pipeline Engine's other chunks run as its M
        microbatches (the JAX Engine's order, engine.py:556-578)."""
        if sp:
            whole = self._all_layers(state) if self._pp_m else state
            x, whole = self._spf(params, whole, tokens)
            first, end = self._layers()
            return (all_gather(self.mesh, "model", x, dim=1),
                    {k: a[first:end] for k, a in whole.items()})
        if self._pp_m:
            M = self._pp_m
            b, T = ln.shape[0], (tokens if embeds is None else embeds).shape[1]
            st = {k: a.unflatten(1, (M, b // M)) for k, a in state.items()}
            x, st = run_pipeline(
                self.info, self.mesh, params, st,
                None if tokens is None else tokens.reshape(M, b // M, T), ln.reshape(M, -1),
                rescale=self.rescale,
                input_embeds=None if embeds is None else embeds.unflatten(0, (M, b // M)))
            return x.flatten(0, 1), {k: a.flatten(1, 2) for k, a in st.items()}
        return forward_chunk(self._info_fwd, params, state, tokens, ln, rescale=self.rescale,
                             hooks=self.hooks, input_embeds=embeds)

    def _chunk_params(self, chunk):
        """The params a chunk's length T routes it to: the dense prefill
        copy from ``prefill_dense_min_t`` tokens on, where the engine has
        one (engine.py:483-487 of the JAX package)."""
        if self._params_prefill is not None and chunk.shape[1] >= self._prefill_min_t:
            return self._params_prefill
        return self.params

    def _step_graphs(self) -> StepGraphs:
        """The engine's graphs, made at the first call; every graph is
        dropped when the engine's params or dense prefill copy is another
        object than they were captured on."""
        if self._graphs is None:
            self._graphs = StepGraphs(self.state, pool=self._graph_pool)
        held = (self.params, self._params_prefill)
        if self._graph_params is None or any(a is not b for a, b in zip(held,
                                                                         self._graph_params)):
            self._graphs.drop()
            self._graph_params = held
        return self._graphs

    def _replay(self, last: bool, params, chunk, lens: list[int]):
        """One chunk as the replay of its bucket's graph, the engine's hooks
        in it, the state updated in place: for ids ``[B, T]`` each lane's
        last-token logits ``[B, V]`` (``last``: the JAX engine's
        ``_fwd_last``, the head in the graph) or the residual ``x [B, T,
        C]``; for embeddings ``[B, T, C]`` (a static input of the
        ``("embeds", T)`` graph: the JAX engine's ``_forward_embeds``) x."""
        embeds = isinstance(chunk, torch.Tensor)
        B, T = chunk.shape[:2]
        info, rescale, hooks = self._info_fwd, self.rescale, self.hooks

        def make(static, state):
            tokens, inp, ln = static.get("tokens"), static.get("embeds"), static["lens"]

            def fn():
                x, new = forward_chunk(info, params, state, tokens, ln, rescale=rescale,
                                       hooks=hooks, input_embeds=inp)
                commit(state, new)
                if not last:
                    return (x,)
                idx = torch.clamp(ln - 1, 0, T - 1)
                return (logits_head(params, x[torch.arange(B, device=x.device), idx],
                                    hooks=hooks),)
            return fn

        inputs = {"embeds": chunk} if embeds else {"tokens": torch.from_numpy(chunk)}
        inputs["lens"] = torch.tensor(lens, dtype=torch.long)
        key = ("embeds" if embeds else "last" if last else "full", T)
        (out,), self.state = self._step_graphs().run(key, params, make, inputs, self.state)
        return out

    def _forward(self, chunk, lens: list[int]):
        """The chunk's forward (ids ``[B, T]`` or embeddings ``[B, T, C]``,
        from :meth:`_chunk_tokens`) on the params its length T routes it
        to (:meth:`_chunk_params`), the sequence-parallel prefill where
        :meth:`_sp_ok` says so: ``(x, lengths [B] or None on a graph
        replay, new state, params)``."""
        params = self._chunk_params(chunk)
        if self.graph:
            return self._replay(False, params, chunk, lens), None, self.state, params
        ln = torch.as_tensor(lens, dtype=torch.long, device=self.device)[self._lanes]
        tokens, embeds = ((None, chunk[self._lanes]) if isinstance(chunk, torch.Tensor)
                          else (torch.as_tensor(chunk[self._lanes], device=self.device), None))
        x, state = self._run(params, self.state, tokens, ln, embeds, self._sp_ok(chunk, lens))
        return x, ln, state, params

    def _forward_last(self, chunk, lens: list[int]):
        """The chunk's forward and each lane's last-token logits ``[B, V]``
        (on the device; under a mesh every lane's, on every rank), the head
        from the same params as the chunk. On a graph engine a chunk of ids
        replays its ``("last", T)`` graph, the head in it; an embedding
        chunk replays its forward and runs the head eagerly."""
        if self.graph and not isinstance(chunk, torch.Tensor):
            return self._replay(True, self._chunk_params(chunk), chunk, lens), self.state
        x, ln, state, params = self._forward(chunk, lens)
        if ln is None:
            ln = torch.as_tensor(lens, dtype=torch.long, device=x.device)
        idx = torch.clamp(ln - 1, 0, x.shape[1] - 1)
        rows = x[torch.arange(x.shape[0], device=x.device), idx]
        return self._gather_lanes(self._head(params, rows)), state

    def _gather_lanes(self, t):
        """Per-lane rows of this rank's lanes, gathered over ``data``."""
        return t if self.mesh is None else all_gather(self.mesh, "data", t, dim=0)

    def _head(self, params, rows):
        """The head on ``rows``, with the engine's hooks where it has any
        (under a mesh its vocabulary slices gathered over ``model``)."""
        if isinstance(params, LocalParams):
            return tp_head(params, rows, self.hooks)
        if self.hooks is None:
            return logits_head(params, rows)
        return logits_head(params, rows, hooks=self.hooks)

    def _mesh_step(self, params, state, token, lens):
        """One decode step under a mesh, as ``make_generator(step=)`` takes
        it: every lane's token ``[B, 1]`` and length ``[B]`` in, every
        lane's logits ``[B, V]`` and this rank's new state out."""
        x, state = self._run(params, state, token[self._lanes], lens[self._lanes])
        return self._gather_lanes(self._head(params, x[:, 0])), state

    def _row_logits(self, x, rows_b: list[int], rows_t: list[int], counts: list[int]):
        """Logits ``[n, V]`` (numpy) of the rows ``(rows_b[i], rows_t[i])``
        of the chunk's residual ``x``, lane by lane as ``counts`` gives
        them. The head runs on a power-of-two row count (engine.py:604-611
        of the JAX package); under a mesh each data rank runs its own lanes'
        rows, padded to the largest rank's count, and the results are
        gathered. On a graph engine too the head runs eagerly here, once a
        chunk: its row count follows the FULL lanes' lengths, so a graph
        would be captured for each count, and the chunk's forward is
        already one replay."""
        lo, per = self._lanes.start, self._lanes.stop - self._lanes.start
        sizes = [sum(counts[i:i + per]) for i in range(0, self.num_batch, per)]
        first, n = sum(sizes[:lo // per]), sizes[lo // per]
        npad = _bucket(max(sizes), 1 << 30)
        bi = torch.zeros(npad, dtype=torch.long)
        ti = torch.zeros(npad, dtype=torch.long)
        bi[:n] = torch.tensor(rows_b[first:first + n], dtype=torch.long) - lo
        ti[:n] = torch.tensor(rows_t[first:first + n], dtype=torch.long)
        rows = x[bi.to(x.device), ti.to(x.device)]
        logits = self._gather_lanes(self._head(self.params, rows)).cpu().numpy()
        return np.concatenate([logits[d * npad:d * npad + c] for d, c in enumerate(sizes)])

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

        # an embedding chunk, a pipeline Engine's and a sequence-parallel
        # chunk take the general path, as in the JAX engine
        if (not isinstance(tokens, torch.Tensor) and not self._pp_m
                and not self._sp_ok(tokens, lens)
                and all(p.option in (None, RnnOption.LAST) for p in plan)):
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

        x, _, self.state, _ = self._forward(tokens, lens)
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
        return _split_rows(self._row_logits(x, rows_b, rows_t, counts), counts)

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
        sample = make_sampler(temperature, top_k, top_p)
        if self._pp_m or self._spf is not None:
            # the JAX Engine's non-lean prefill (engine.py:649): infer() a
            # chunk at a time, each lane's last logits row
            last = [None] * self.num_batch
            while inp.num_token:
                for b, rows in enumerate(self.infer(inp).batches):
                    if len(rows):
                        last[b] = rows[-1]
            logits = torch.from_numpy(np.stack(last)).to(self.device)
            return sample(logits, generator)[:, None], generator
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
        return sample(logits, generator)[:, None], generator

    def _generator(self, steps, temperature, top_k, top_p, stop_ids):
        """``make_generator``'s decode segment for one sampling config,
        made once (the JAX engine's ``_gen_cache``, engine.py:274-279 and
        729-735): on a graph engine captured into the engine's graphs, so a
        later ``generate()`` replays it."""
        key = (steps, temperature, top_k, top_p, stop_ids)
        run = self._gen_cache.get(key)
        if run is None:
            run = self._gen_cache[key] = make_generator(
                self.info, steps=steps, temperature=temperature, top_k=top_k, top_p=top_p,
                rescale=self.rescale, stop_ids=stop_ids, hooks=self.hooks,
                step=self._mesh_step if self.mesh is not None else None,
                graph=self._step_graphs() if self.graph else False)
        return run

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
        return _generate([self], [prompts], max_tokens, temperature, top_k, top_p,
                         stop_tokens, seed, segment)


def _generate(engines, groups, max_tokens, temperature, top_k, top_p, stop_tokens, seed,
              segment) -> list[list[int]]:
    """``generate`` over engines of one model, engine i on prompt group i
    with sampling seed ``seed + i``: every engine's prefill, then every
    engine's segment of each round, is dispatched before anything is read
    back from the device; the rounds end once every lane of every engine
    has stopped. The lanes' tokens, group after group."""
    stop_tokens = stop_tokens or set()
    runs = [e._generator(segment, temperature, top_k, top_p, tuple(sorted(stop_tokens)))
            for e in engines]
    firsts, generators = zip(*(e._gen_prefill(g, temperature, top_k, top_p, seed + i)
                               for i, (e, g) in enumerate(zip(engines, groups))))
    tokens, generators = list(firsts), list(generators)
    segs = [[] for _ in engines]
    produced = 1
    while produced < max_tokens:
        dones = []
        for i, e in enumerate(engines):
            toks, _, e.state, generators[i], done = runs[i](e.params, e.state, tokens[i],
                                                        generators[i])
            segs[i].append(toks)
            tokens[i] = toks[:, -1:]
            dones.append(done)
        produced += segment
        if stop_tokens and all(bool(d.all()) for d in dones):
            break  # every lane froze on its stop token
    results = []
    for first, eng_segs in zip(firsts, segs):
        rows = [[t] for t in first[:, 0].tolist()]
        if eng_segs:
            for b, row in enumerate(torch.cat(eng_segs, dim=1).tolist()):
                rows[b].extend(row)
        results.extend(rows)
    return _trim_stop(results, max_tokens, stop_tokens)


class EnginePool:
    """More lanes than one whole-stack decode launch takes, served as a
    pool of engines over one set of weights (the JAX package's
    ``EnginePool``).

    ``num_lanes`` splits into near-equal groups of at most
    ``lanes_per_engine`` (default ``MAX_SCAN_BATCH``), one engine each.
    Dense decode and the decode preparation are resolved once here, so
    every engine holds the same params object; where chunks prefill on a
    dense copy, that copy is built once, before the engines, and every
    engine holds the same one (a second copy never exists, where the JAX
    pool builds one per engine and keeps the first). ``engine_kwargs`` go
    to each :class:`Engine`; with ``mesh=`` the weights are placed once (by
    ``tp_mode``, or a pipeline stage's or the whole model's for
    ``pipeline_microbatches`` and ``seq_parallel``) and every engine serves
    its group's lanes across the mesh. Without one, each engine keeps its
    own CUDA graphs and state, and all of them share one memory pool."""

    def __init__(self, info: ModelInfo, params, num_lanes: int, *,
                 lanes_per_engine: int | None = None, device="cuda", **engine_kwargs):
        if lanes_per_engine is None:
            lanes_per_engine = MAX_SCAN_BATCH
        if num_lanes <= 0:
            raise EngineError("num_lanes must be positive")
        n_eng = -(-num_lanes // lanes_per_engine)
        base, rem = divmod(num_lanes, n_eng)
        self.group_sizes = [base + (1 if i < rem else 0) for i in range(n_eng)]
        self.info = info
        mesh = engine_kwargs.get("mesh")
        self.device = torch.device(device) if mesh is None else mesh.device
        first = self.group_sizes[0]
        decode_dense = engine_kwargs.pop("decode_dense", None)
        prefill_dense = engine_kwargs.pop("prefill_dense", None)
        min_t = engine_kwargs.pop("prefill_dense_min_t", 64)
        if mesh is not None:
            # the weights placed once, every engine holding this rank's
            # shard (under a mesh there is no dense copy and no decode
            # preparation: the JAX pool's engine.py:807)
            plan = _mesh_plan(mesh, engine_kwargs.get("tp_mode", "gspmd"),
                              engine_kwargs.get("seq_parallel"),
                              engine_kwargs.get("pipeline_microbatches"), first,
                              engine_kwargs.get("hooks"))
            params = _placed(params, mesh, info, plan)
            self.params_quantized = prefill = None
        else:
            params, self.params_quantized, prefill = _dense_weights(
                params, first, decode_dense, prefill_dense, memory_limit(self.device))
            if engine_kwargs.get("unroll") is not False:
                params = prepare_decode(params, info, batch_hint=first)
        self.params = params
        self.engines = [Engine(info, params, g, decode_dense=False, prefill_dense=False,
                               prefill_dense_min_t=min_t, device=device, **engine_kwargs)
                        for g in self.group_sizes]
        # one memory pool for every engine's graphs: they replay in turn on
        # one stream, and nothing of a graph's pool outlives its replay
        pool = new_pool(self.device) if mesh is None else None
        for eng in self.engines:
            eng._params_prefill = prefill
            eng._graph_pool = pool

    @property
    def num_lanes(self) -> int:
        return sum(self.group_sizes)

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
        """:meth:`Engine.generate` over the pool: lane i takes prompt i, and
        engine i samples from seed + i, so each lane gives what a
        standalone engine of its group's size gives. Every engine's prefill
        and then every engine's segment is dispatched before anything is
        read back from the card."""
        if len(prompts) != self.num_lanes:
            raise TensorError.batch(len(prompts), self.num_lanes)
        bounds = np.cumsum([0] + self.group_sizes)
        return _generate(self.engines, [prompts[bounds[i]:bounds[i + 1]]
                                        for i in range(len(self.engines))],
                         max_tokens, temperature, top_k, top_p, stop_tokens, seed, segment)
