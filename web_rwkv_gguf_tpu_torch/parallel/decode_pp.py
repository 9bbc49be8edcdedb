"""Pipeline-parallel decode: the whole-stack decode kernel per stage.

The port of the JAX package's ``parallel/decode_pp.py``. Tensor-parallel
decode cannot keep the whole-stack kernels (a layer needs a collective
in its middle), but a pipeline over the layer stack can: each stage (a
rank of the mesh's ``pp`` axis) holds only its own ``L / S`` layers and
runs the port's ``layer_scan7(..., v0_carry=(v_first, first_layer))``
(RWKV-7, ``ops/cuda/layer7.py``) or ``layer_scan56(..., first_layer=)``
(RWKV-6, -5, -4, ``ops/cuda/layer56.py``) on them, unchanged. Between
stages cross only x ``[B, C]`` and, on RWKV-7, the value-residual anchor
v0 (the JAX package's ``ppermute``); the sampled ids go back from the
last stage to stage 0 (its psum into the token table).

Decode is autoregressive, so one sequence cannot be pipelined, but
``G`` groups of ``B`` lanes can: group g's token t + 1 enters stage 0
once its token t has left the last stage, so G ≥ S keeps every stage
busy. Each rank walks its jobs (group, step) in order, receives its
input from the stage before (stage 0: the group's token, embedded),
runs its layers, and sends on; the last stage runs the head and the
sampler (``models.generate.make_sampler``, with an explicit
``torch.Generator``) and sends the ids to stage 0. At the end the last
stage broadcasts every sampled id to all stages.
"""

from __future__ import annotations

import torch

from ..errors import EngineError, UnsupportedFeature
from ..models.forward import GN_EPS, L2_EPS, LN_EPS, embed_tokens, init_state, logits_head
from ..models.generate import make_sampler
from ..models.info import ModelInfo, ModelVersion
from ..ops.cuda.layer7 import layer_scan7, mega_layers
from ..ops.cuda.layer56 import layer_scan56
from .sharding import Mesh, broadcast, recv, send


def _find_mega(params: dict) -> dict:
    """The attached whole-stack decode blocks (RWKV-7's ``mega7``, or the
    RWKV-6/5/4 ``mega56``), or raise."""
    mega = params.get("mega7") or params.get("mega56")
    if mega is None:
        raise UnsupportedFeature("pipelined decode needs the whole-stack decode blocks "
                                 "(models.loader.prepare_decode)")
    return mega


def _clone(tree):
    """Contiguous copies of every tensor of a decode-block tree, so that a
    stage holds its layers alone once the whole stack is dropped."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _stage(mesh: Mesh, axis: str, L: int) -> tuple[int, int, int]:
    """``(stage, stages, layers a stage)`` of this rank."""
    S = mesh.shape[axis]
    if L % S:
        raise EngineError(f"num_layer {L} must divide pipeline stages {S}")
    return mesh.coord(axis), S, L // S


def make_pp_params(params: dict, mesh: Mesh, *, axis: str = "pp") -> dict:
    """This stage's parameters for the pipelined decoder: its layers of the
    whole-stack blocks (copied), ``first_layer`` (its global offset), and
    what its end of the pipe needs: the embedding and ln0 on stage 0,
    ln_out and the head on the last stage. ``params`` must carry
    ``mega7`` (RWKV-7) or ``mega56`` (RWKV-6, -5, -4), as
    ``models.loader.prepare_decode`` attaches them."""
    mega = _find_mega(params)
    stage, S, lps = _stage(mesh, axis, mega["L"])
    lo = stage * lps
    out = {"mega": _clone(mega_layers(mega, lo, lo + lps)), "first_layer": lo,
           "L": mega["L"]}
    if stage == 0:
        out.update(emb=params["emb"], ln0=params["ln0"])
    if stage == S - 1:
        out.update(ln_out=params["ln_out"], head=params["head"])
    return out


def pp_state(info: ModelInfo, n_groups: int, batch: int, *, mesh: Mesh | None = None,
             axis: str = "pp", device="cuda") -> dict:
    """Zero recurrent state for the pipelined decoder: leaves ``[L, G, B,
    ...]``; with ``mesh`` only this stage's ``L / S`` layers, on the
    mesh's device."""
    if mesh is not None:
        device = mesh.device
    base = init_state(info, batch, device=device)
    lo, hi = 0, info.num_layer
    if mesh is not None:
        stage, _, lps = _stage(mesh, axis, info.num_layer)
        lo, hi = stage * lps, (stage + 1) * lps
    return {k: a[lo:hi, None].expand(hi - lo, n_groups, *a.shape[1:]).clone()
            for k, a in base.items()}


def greedy_scan_reference(info: ModelInfo, params: dict, token0, steps: int,
                          rescale: int | None = None):
    """Single-rank greedy decode on the same kernels as the pipelined
    generator (the whole-stack kernel on every layer, ``logits_head``,
    argmax): the parity reference of :func:`make_pp_generator`. Returns
    ``(tokens [B, steps], state)``."""
    mega = _find_mega(params)
    B = token0.shape[0]
    dev = params["emb"].device
    state = init_state(info, B, device=dev)
    mask = torch.ones(B, device=dev)
    do_rescale = rescale if rescale is not None and rescale < mega["L"] else None
    tok = torch.as_tensor(token0, device=dev).long()
    toks = []
    for _ in range(steps):
        x = embed_tokens(params, tok[:, None])[:, 0]
        if info.version == ModelVersion.V7:
            xo, state = layer_scan7(mega, state, x, mask, do_rescale, LN_EPS, GN_EPS, L2_EPS)
        else:
            xo, state = layer_scan56(mega, state, x, mask, do_rescale, LN_EPS, GN_EPS)
        tok = torch.argmax(logits_head(params, xo), dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=-1), state


def make_pp_generator(info: ModelInfo, mesh: Mesh, mega_static: dict, *, n_groups: int,
                      steps: int, temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 0.0, rescale: int | None = None, axis: str = "pp"):
    """``fn(pp_params, state, token0 [G, B], generator=None) -> (tokens [G,
    B, steps], state)``: ``steps`` tokens for each of ``G`` groups of ``B``
    lanes, pipelined over the mesh's ``axis`` stages. ``pp_params`` from
    :func:`make_pp_params`; ``state`` this stage's ``[L / S, G, B, ...]``
    (:func:`pp_state` with the mesh), updated in place and returned;
    ``mega_static`` the whole stack's blocks or any dict with their layer
    count ``"L"``. Greedy (temperature 0) gives, per group, what
    :func:`greedy_scan_reference` gives: the same kernels on the same
    layers, the same head, the same argmax."""
    stage, S, lps = _stage(mesh, axis, mega_static["L"])
    if n_groups < S:
        raise EngineError(f"need n_groups >= stages to fill the pipe ({n_groups} < {S}): a "
                          "group's next token can only enter once its previous one left")
    _, ranks = mesh.group(axis)
    first, last = ranks[0], ranks[-1]
    prev = ranks[stage - 1] if stage > 0 else None
    nxt_rank = ranks[stage + 1] if stage < S - 1 else None
    G, jobs = n_groups, n_groups * steps
    sample = make_sampler(temperature, top_k, top_p)
    v7 = info.version == ModelVersion.V7
    do_rescale = rescale if rescale is not None and rescale < mega_static["L"] else None

    def run(pp, state, token0, generator=None):
        dev = mesh.device
        token0 = torch.as_tensor(token0, device=dev).long()
        B, C = token0.shape[1], info.num_emb
        mask = torch.ones(B, device=dev)
        x_like = torch.empty(B, C, device=dev)
        tok_like = torch.empty(B, dtype=torch.long, device=dev)
        out = torch.zeros(G, B, steps, dtype=torch.long, device=dev)
        pending = []  # sends in flight, waited on at the end
        for j in range(jobs):
            g, k = j % G, j // G
            if stage == 0:
                if j < G:
                    tok = token0[g]
                elif S == 1:
                    tok = out[g, :, k - 1]
                else:
                    tok = recv(tok_like, last, device=dev)
                x, v0 = embed_tokens(pp, tok[:, None])[:, 0], None
            else:
                x = recv(x_like, prev, device=dev)
                v0 = recv(x_like, prev, device=dev) if v7 else None
            lst = {key: a[:, g] for key, a in state.items()}
            if v7:
                xo, new, v0 = layer_scan7(pp["mega"], lst, x, mask, do_rescale, LN_EPS,
                                          GN_EPS, L2_EPS, v0_carry=(v0, pp["first_layer"]))
            else:
                xo, new = layer_scan56(pp["mega"], lst, x, mask, do_rescale, LN_EPS, GN_EPS,
                                       first_layer=pp["first_layer"])
            for key, a in state.items():
                a[:, g] = new[key]
            if stage < S - 1:
                pending.append(send(xo, nxt_rank, device=dev))
                if v7:
                    pending.append(send(v0, nxt_rank, device=dev))
                continue
            ids = sample(logits_head(pp, xo), generator)
            out[g, :, k] = ids
            if S > 1 and j + G < jobs:
                pending.append(send(ids, first, device=dev))
        for work, _ in pending:
            work.wait()
        group, _ = mesh.group(axis)
        return broadcast(out, last, group=group, device=dev), state

    return run


class PipelinedDecoder:
    """The pipelined decode's product surface: this stage's placed
    parameters, its ``[L / S, G, B, ...]`` state, and a generator a
    ``(G, B, steps)``, so serving code calls :meth:`generate`::

        dec = PipelinedDecoder(info, params, mesh)     # mesh has "pp"
        toks = dec.generate(token0, steps=64)          # [G, B, 64]
        toks = dec.generate(toks[..., -1], steps=64)   # continues

    Every rank of the mesh builds it with the same arguments and calls
    :meth:`generate` with the same tokens. ``params`` may come straight
    from ``load_model``: the whole-stack blocks are prepared here where
    absent. Greedy output equals the single-rank whole-stack generator's,
    group by group (:func:`greedy_scan_reference`)."""

    def __init__(self, info: ModelInfo, params: dict, mesh: Mesh, *, axis: str = "pp",
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 rescale: int | None = None, seed: int = 0):
        if "mega7" not in params and "mega56" not in params:
            from ..models.loader import prepare_decode

            params = prepare_decode(params, info, batch_hint=1)
            if "mega7" not in params and "mega56" not in params:
                raise UnsupportedFeature("pipelined decode needs a uniformly quantized "
                                         "V4/V5/V6/V7 stack (whole-stack decode blocks)")
        self.info, self.mesh, self.axis = info, mesh, axis
        self._static = {"L": _find_mega(params)["L"]}
        self._pp = make_pp_params(params, mesh, axis=axis)
        self._sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                              rescale=rescale)
        self._gens: dict = {}
        self.state = None
        self.generator = torch.Generator(device=mesh.device).manual_seed(seed)

    @property
    def num_stages(self) -> int:
        return self.mesh.shape[self.axis]

    def reset(self, n_groups: int | None = None, batch: int | None = None):
        """Zero the recurrent state (made again at the next
        :meth:`generate` where the sizes are omitted)."""
        self.state = (None if n_groups is None or batch is None
                      else pp_state(self.info, n_groups, batch, mesh=self.mesh, axis=self.axis))

    def generate(self, token0, steps: int, generator: torch.Generator | None = None):
        """``steps`` tokens for every lane: ``token0 [G, B]`` → ``[G, B,
        steps]`` sampled ids (G ≥ the stages). The state carries across
        calls; pass the last column to continue."""
        token0 = torch.as_tensor(token0)
        G, B = token0.shape
        if self.state is None:
            self.state = pp_state(self.info, G, B, mesh=self.mesh, axis=self.axis)
        else:
            sG, sB = next(iter(self.state.values())).shape[1:3]
            if (sG, sB) != (G, B):
                raise EngineError(f"token0 is ({G}, {B}) lanes but the carried state is "
                                  f"({sG}, {sB}); call reset() (or reset(G, B)) before "
                                  "changing the group/batch shape")
        gen = self._gens.get((G, B, steps))
        if gen is None:
            gen = make_pp_generator(self.info, self.mesh, self._static, n_groups=G,
                                    steps=steps, axis=self.axis, **self._sampling)
            self._gens[(G, B, steps)] = gen
        toks, self.state = gen(self._pp, self.state, token0,
                               generator if generator is not None else self.generator)
        return toks
