"""Pipeline parallelism: the layer stack cut over the ranks of one mesh axis.

The port of the JAX package's ``parallel/pipeline.py`` (a GPipe forward).
Each rank of the axis is a stage: it holds its contiguous ``L / S``
layers of the blocks and of the recurrent state, and the embedding, ln0,
ln_out and the head whole (the JAX package's ``params_spec``). The lanes
of a chunk come as M microbatches ``[M, B, T]``.

JAX runs ``S + M - 1`` ticks of one program on every device, moving the
residual x by ``ppermute``. With one process a rank the schedule writes
itself: each stage takes microbatches 0..M-1 in order; stage 0 embeds
(ln0, padding zeroed), every other stage receives x from the stage
before (``sharding.recv``), and on RWKV-7 the value-residual anchor v0
too; it runs its layers with the port's per-layer functions
(``models.forward._layer_v7`` … ``_layer_v4``) at their global index and
sends x on (``sharding.send``, waited on at the end), so that stage s
works on microbatch m while stage s + 1 works on m - 1. Below RWKV-7
only x crosses stages. The last stage's outputs go to every rank of the
axis (JAX's ``psum`` over ``pp``) by one broadcast. ``run_pipeline``'s
``rescale`` halves the residual every N global layers, as
``forward_chunk`` does, for the Engine (the JAX pipeline takes no
``rescale``: ROADMAP, reference faults).

With a ``data`` axis the lanes of each microbatch are split over it, as
the Engine splits its lanes; each rank's state holds its stage's layers
of its own lanes.
"""

from __future__ import annotations

import torch

from ..errors import EngineError, UnsupportedFeature
from ..models.forward import LN_EPS, _LAYERS, _layer_v7, embed_tokens
from ..models.info import ModelInfo, ModelVersion
from ..models.loader import layer_params
from ..models.matrix import Matrix
from ..ops import basic as B
from .sharding import Mesh, all_gather, broadcast, data_sharding, recv, send

VERSIONS = (ModelVersion.V7, ModelVersion.V6, ModelVersion.V5, ModelVersion.V4)
# the parameters every stage holds whole
SHARED = ("emb", "ln0", "ln_out", "head")


def stage_layers(info: ModelInfo, mesh: Mesh, axis: str = "model") -> tuple[int, int]:
    """``(first, end)``: the global layers of this rank's stage on
    ``axis``; raises where the stages do not divide the layers."""
    if info.version not in VERSIONS:
        raise UnsupportedFeature(f"pipeline-parallel forward: unsupported version "
                                 f"{info.version}")
    L, S = info.num_layer, mesh.shape[axis]
    if L % S:
        raise EngineError(f"num_layer {L} must divide by pipeline stages {S}")
    lps = L // S
    return mesh.coord(axis) * lps, (mesh.coord(axis) + 1) * lps


def _copy(tree):
    """Contiguous copies of a layer's tensors and matrices."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, Matrix):
        return Matrix(tree.kind, tree.shape, {k: a.clone() for k, a in tree.arrays.items()})
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def stage_params(params: dict, info: ModelInfo, mesh: Mesh, *, axis: str = "model") -> dict:
    """This stage's parameters: its layers of ``params["blocks"]`` copied,
    as a per-layer list (so that the whole stack can be dropped), beside
    the embedding, ln0, ln_out and the head (shared with ``params``), and
    ``first_layer``, its global offset."""
    first, end = stage_layers(info, mesh, axis)
    layers = layer_params(params, info.num_layer)[first:end]
    out = {k: params[k] for k in SHARED}
    out.update(blocks=[_copy(blk) for blk in layers], first_layer=first)
    return out


def pipeline_state(info: ModelInfo, num_microbatch: int, batch: int, *,
                   mesh: Mesh | None = None, axis: str = "model", device="cuda") -> dict:
    """Zero state shaped for the pipeline: leaves ``[L, M, B, ...]``; with
    ``mesh``, this rank's shard on the mesh's device: its stage's layers
    and, where the mesh has a ``data`` axis, its lanes of B."""
    from ..models.forward import init_state

    first, end, lanes = 0, info.num_layer, slice(0, batch)
    if mesh is not None:
        device = mesh.device
        first, end = stage_layers(info, mesh, axis)
        lanes = data_sharding(mesh, batch)
    base = init_state(info, batch, device=device)
    return {k: a[first:end, None, lanes].expand(end - first, num_microbatch,
                                                *a[:, lanes].shape[1:]).clone()
            for k, a in base.items()}


def run_pipeline(info: ModelInfo, mesh: Mesh, params: dict, state: dict, tokens, lengths, *,
                 axis: str = "model", rescale: int | None = None, input_embeds=None):
    """The pipeline on this rank's lanes: ``tokens`` ``[M, B, T]`` ids
    (or ``input_embeds`` ``[M, B, T, C]``, the rows before ln0, with
    ``tokens`` None), ``lengths`` ``[M, B]``, ``state`` this stage's
    ``[L / S, M, B, ...]``. ``params`` are :func:`stage_params` or the
    whole model's (then this stage's layers are views of it). Returns
    ``(x [M, B, T, C] on every rank of the axis, new_state)``; ``state``
    is left as it was."""
    first, end = stage_layers(info, mesh, axis)
    if "first_layer" in params:
        layers = params["blocks"]
    else:
        layers = layer_params(params, info.num_layer)[first:end]
    stage, S = mesh.coord(axis), mesh.shape[axis]
    group, ranks = mesh.group(axis)
    dev = mesh.device
    lead = tokens if input_embeds is None else input_embeds
    M, Bm, T = lead.shape[:3]
    C, v7 = info.num_emb, info.version == ModelVersion.V7
    do_rescale = rescale is not None and rescale < info.num_layer
    lengths = torch.as_tensor(lengths, device=dev)
    x_like = torch.empty(Bm, T, C, device=dev)
    out = torch.zeros(M, Bm, T, C, device=dev)
    pending, news = [], []
    for m in range(M):
        lens = lengths[m]
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
        if stage == 0:
            if input_embeds is None:
                x = embed_tokens(params, torch.as_tensor(tokens[m], device=dev))
            else:
                x = B.layer_norm(input_embeds[m].float(), params["ln0"]["w"],
                                 params["ln0"]["b"], LN_EPS)
            x, v0 = torch.where(mask[..., None], x, 0.0), None
        else:
            x = recv(x_like, ranks[stage - 1], device=dev)
            v0 = recv(x_like, ranks[stage - 1], device=dev) if v7 else None
        mb_new = []
        for j, blk in enumerate(layers):
            i = first + j
            lst = {k: a[j, m] for k, a in state.items()}
            if v7:
                x, v0, new = _layer_v7(info, blk, lst, x, v0, i, mask, lens)
            else:
                x, new = _LAYERS[info.version](info, blk, lst, x, mask, lens)
            if do_rescale and (i + 1) % rescale == 0:
                x = x * 0.5
            mb_new.append(new)
        news.append(mb_new)
        if stage < S - 1:
            pending.append(send(x, ranks[stage + 1], device=dev))
            if v7:
                pending.append(send(v0, ranks[stage + 1], device=dev))
        else:
            out[m] = x
    for work, _ in pending:
        work.wait()
    new_state = {k: torch.stack([torch.stack([n[k] for n in mb]) for mb in news], dim=1)
                 for k in state}
    if group is not None:
        out = broadcast(out, ranks[-1], group=group, device=dev)
    return out, new_state


def make_pipeline_forward(info: ModelInfo, mesh: Mesh, *, axis: str = "model",
                          num_microbatch: int = 4):
    """The pipeline-parallel forward of any model version (the JAX
    package's ``make_pipeline_forward``).

    ``fn(params, state, tokens [M, B, T], lengths [M, B]) -> (x [M, B, T,
    C], new_state)`` with M = ``num_microbatch`` groups of B sequences.
    Every rank is given the same tokens and lengths and returns the same
    x; ``params`` are the whole model's or this stage's
    (:func:`stage_params`); ``state`` and ``new_state`` are this rank's
    shard (:func:`pipeline_state` with the mesh). Apply
    ``models.logits_head`` to the returned x as usual."""
    stage_layers(info, mesh, axis)
    with_data = "data" in mesh.shape

    def fn(params, state, tokens, lengths):
        tokens, lengths = torch.as_tensor(tokens), torch.as_tensor(lengths)
        if tokens.shape[0] != num_microbatch:
            raise EngineError(f"tokens hold {tokens.shape[0]} microbatches, the forward "
                              f"{num_microbatch}")
        lanes = data_sharding(mesh, tokens.shape[1]) if with_data else slice(None)
        x, new_state = run_pipeline(info, mesh, params, state, tokens[:, lanes],
                                    lengths[:, lanes], axis=axis)
        if with_data:
            x = all_gather(mesh, "data", x, dim=1)
        return x, new_state

    return fn
