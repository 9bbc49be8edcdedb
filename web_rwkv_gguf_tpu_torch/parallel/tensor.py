"""Tensor parallelism: this rank's weights and the collectives around them.

The port of the JAX package's ``parallel/tensor.py``, in both of the
Engine's ``tp_mode``s, each as explicit collectives on a
:class:`~.sharding.Mesh`:

- ``"shard_map"`` (:func:`shard_params_tp`), the all-column plan: every
  weight matrix is cut on its output rows M. Projections of the
  replicated residual (att Wr/Wk/Wv/Wg, FFN Wk, the head) multiply
  locally; a matrix whose input is itself cut (att Wo, FFN Wv) gathers
  that input over ``model``, multiplies, and gathers its output; the
  RWKV-6/5/4 FFN receptance multiplies locally and gathers its output.
- ``"gspmd"`` (``sharding.shard_params``), the column/row plan: the same
  column-parallel products, while att Wo, FFN Wv and the FFN receptance
  are cut on K and followed by one ``all_reduce`` over ``model``, the
  psum XLA inserts for the JAX package. The partial sums add in another
  order than one product does, so this plan is held at the quantized
  tolerance, not bit for bit. A K that does not split in whole GGML
  units (``sharding.row_shardable``) keeps its matrix whole, its input
  gathered.

In both, the attention heads (RWKV-4: its channels) are co-sharded with
their projections, so the WKV recurrence needs no communication; the
output-side per-head vectors (:data:`ATT_SLICES`) and the group norm are
cut to this rank's heads, and the forward runs ``models.forward_chunk``
unchanged on the local weights with ``num_head`` = H / n_model. Every
kernel sees an ordinary rank-local matrix, so each shard routes to the
kernel its full matrix takes.

The JAX package's per-shard gemv scale operands (``_reshard_gemv_arrays``)
and its packed gemv layouts are the TPU kernels' layout; the port's
kernels read the raw factors, which cut along M like every other array,
so nothing of them is carried over.
"""

from __future__ import annotations

import dataclasses

import torch

from ..errors import EngineError, UnsupportedFeature
from ..models.forward import forward_chunk, logits_head
from ..models.info import ModelInfo, ModelVersion
from ..models.matrix import Matrix
from .sharding import (Mesh, all_gather, all_reduce, col_shard, col_shardable, data_sharding,
                       row_shard, row_shardable)

# att vectors cut to this rank's heads: (key, axis from the end, "C" | "H")
# per version, the output-side parameters only (the JAX package's
# _ATT_SLICES, without its stacked ``lora_up`` copy, which the port lacks)
ATT_SLICES = {
    # RWKV-4's WKV is per channel: its state and vectors cut on C
    ModelVersion.V4: (("time_first", 1, "C"), ("time_decay", 1, "C")),
    ModelVersion.V5: (("time_first", 2, "H"), ("time_decay", 2, "H")),
    ModelVersion.V6: (("time_first", 2, "H"), ("time_decay", 1, "C"), ("td_w2", 2, "C")),
    ModelVersion.V7: (("k_k", 1, "C"), ("k_a", 1, "C"), ("w0", 1, "C"), ("a0", 1, "C"),
                      ("v0", 1, "C"), ("r_k", 2, "H"), ("w2", 2, "C"), ("a2", 2, "C"),
                      ("g2", 2, "C"), ("v2", 2, "C")),
}
TP_MODES = ("gspmd", "shard_map")


class TPMatrix(Matrix):
    """A rank-local matrix and the collectives around its product over
    ``model``: ``gather_in`` gathers a cut input first (JAX's
    ``_GatherInCol``), ``slice_in`` cuts a whole input to this rank's K
    range; ``out`` is ``"local"`` (the product as it is), ``"gather"``
    (gathered over the ranks' rows: ``_ColGatherOut``) or ``"sum"`` (the
    ranks' partial products summed: the row-parallel psum)."""

    def __init__(self, mat: Matrix, mesh: Mesh, *, gather_in=False, slice_in=False,
                 out="local"):
        super().__init__(mat.kind, mat.shape, mat.arrays)
        self.mesh, self.gather_in, self.slice_in, self.out = mesh, gather_in, slice_in, out

    def layer(self, i: int) -> "TPMatrix":
        return TPMatrix(super().layer(i), self.mesh, gather_in=self.gather_in,
                        slice_in=self.slice_in, out=self.out)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if self.gather_in:
            x = all_gather(mesh, "model", x, dim=-1)
        if self.slice_in:
            k = self.dims()[1]
            x = x[..., mesh.coord("model") * k:(mesh.coord("model") + 1) * k]
        y = super().matmul(x)
        if self.out == "gather":
            return all_gather(mesh, "model", y, dim=-1)
        if self.out == "sum":
            return all_reduce(mesh, "model", y)
        return y


class LocalParams(dict):
    """This rank's parameters (a dict as ``load_model`` returns), with the
    placement they came from: ``mesh``, ``plan`` (a :data:`TP_MODES`
    entry), ``info`` (the model as this rank runs it: ``num_head`` = H /
    n_model) and ``head_sharded`` (the head cut on the vocabulary, whose
    logits are gathered after it)."""

    mesh: Mesh
    plan: str
    info: ModelInfo
    head_sharded: bool


def local_info(info: ModelInfo, n: int) -> ModelInfo:
    """``info`` as a rank of n on ``model`` runs it: H / n heads (RWKV-4
    keeps its one)."""
    return dataclasses.replace(info, num_head=max(1, info.num_head // n))


def check_divides(info: ModelInfo, n: int):
    """Raise unless C, H (but RWKV-4) and the FFN width divide by n."""
    h_ok = info.version == ModelVersion.V4 or info.num_head % n == 0
    if info.num_emb % n or not h_ok or info.num_hidden % n:
        raise EngineError(f"C/H/hidden must divide model axis ({n})")


# column-parallel projections of the replicated residual
_COLUMN = {("att", "Wr"), ("att", "Wk"), ("att", "Wv"), ("att", "Wg"), ("ffn", "Wk")}
# matrices whose input is cut on model (the heads' output, the FFN hidden)
_CUT_INPUT = {("att", "Wo"), ("ffn", "Wv")}
# each placement: how the matrix is cut (None: whole) and the collectives of
# its TPMatrix (None: a plain replicated matrix)
PLACEMENTS = {
    "col": (col_shard, {}),
    "col-gather": (col_shard, {"out": "gather"}),
    "col-gather-in": (col_shard, {"gather_in": True, "out": "gather"}),
    "row-sum": (row_shard, {"out": "sum"}),
    "row-slice-sum": (row_shard, {"slice_in": True, "out": "sum"}),
    "whole-gather-in": (None, {"gather_in": True}),
    "whole": (None, None),
}


def placement(part: str, name: str, mat: Matrix, n: int, plan: str) -> str:
    """How ``plan`` places the matrix ``part.name`` (``"head"`` for the
    head) over n ranks on ``model``: a :data:`PLACEMENTS` key. Column-
    parallel projections cut their rows; under ``"shard_map"`` the others
    cut their rows too and gather around the product; under ``"gspmd"``
    they cut K and add the partial products where K splits in whole units
    (``sharding.row_shardable``), else stay whole (a cut input gathered
    first). The head cuts its vocabulary wherever n divides it."""
    if part == "head":
        return "col" if n > 1 and col_shardable(mat, n) else "whole"
    if (part, name) in _COLUMN:
        return "col"
    cut_input = (part, name) in _CUT_INPUT
    if plan == "shard_map":
        return "col-gather-in" if cut_input else "col-gather"
    if row_shardable(mat, n):
        return "row-sum" if cut_input else "row-slice-sum"
    return "whole-gather-in" if cut_input else "whole"


def place_matrix(mat: Matrix, how: str, mesh: Mesh) -> Matrix:
    """``mat`` placed as :func:`placement` said: this rank's cut, wrapped
    with its collectives."""
    cut, kw = PLACEMENTS[how]
    if cut is not None:
        mat = cut(mat, mesh.coord("model"), mesh.shape["model"])
    return mat if kw is None else TPMatrix(mat, mesh, **kw)


def _cut(a: torch.Tensor, axis_from_end: int, size: int, r: int) -> torch.Tensor:
    dim = a.dim() - axis_from_end
    return a.narrow(dim, r * size, size).contiguous()


def place_params(params: dict, mesh: Mesh, info: ModelInfo, plan: str) -> LocalParams:
    """This rank's parameters under ``plan`` (see the module docstring):
    the matrices placed and wrapped with their collectives, the
    output-side att vectors and the group norm cut to the local heads,
    everything else shared with ``params`` (replicated). Copies of the
    cut arrays, so a rank that drops ``params`` holds only its shard."""
    if plan not in TP_MODES:
        raise EngineError(f"unknown tp_mode {plan!r}")
    if isinstance(params["blocks"], list):
        raise UnsupportedFeature("tensor parallelism requires the stacked (scan) form; "
                                 "use a uniform quant scheme")
    if info.version not in ATT_SLICES:
        raise UnsupportedFeature(f"tensor parallelism: unsupported version {info.version}")
    n, r = mesh.shape["model"], mesh.coord("model")
    check_divides(info, n)
    c_loc, h_loc = info.num_emb // n, max(1, info.num_head // n)
    blocks = dict(params["blocks"])
    att, ffn = dict(blocks["att"]), dict(blocks["ffn"])
    for part, tree in (("att", att), ("ffn", ffn)):
        for k, v in tree.items():
            if isinstance(v, Matrix):
                tree[k] = place_matrix(v, placement(part, k, v, n, plan), mesh)
    for k, ax, unit in ATT_SLICES[info.version]:
        if k in att:
            att[k] = _cut(att[k], ax, h_loc if unit == "H" else c_loc, r)
    if "gn" in att:
        att["gn"] = {k: _cut(a, 1, c_loc, r) for k, a in att["gn"].items()}
    blocks["att"], blocks["ffn"] = att, ffn
    out = LocalParams({key: v for key, v in params.items()
                       if key not in ("mega7", "mega56", "blocks", "head")})
    out["blocks"] = blocks
    out.head_sharded = placement("head", "", params["head"], n, plan) == "col"
    out["head"] = col_shard(params["head"], r, n) if out.head_sharded else params["head"]
    out.mesh, out.plan, out.info = mesh, plan, local_info(info, n)
    return out


def shard_params_tp(params: dict, mesh: Mesh, info: ModelInfo) -> LocalParams:
    """This rank's parameters for :func:`make_tp_forward` under the
    all-column plan (``tp_mode="shard_map"``)."""
    return place_params(params, mesh, info, "shard_map")


def tp_head(params: LocalParams, rows: torch.Tensor, hooks: dict | None = None) -> torch.Tensor:
    """``logits_head`` on this rank's head, its vocabulary slices gathered
    over ``model`` afterwards (the taps see this rank's slice, as under the
    JAX package's ``shard_map``)."""
    lg = logits_head(params, rows) if hooks is None else logits_head(params, rows, hooks=hooks)
    return all_gather(params.mesh, "model", lg, dim=-1) if params.head_sharded else lg


def make_tp_head(mesh: Mesh, params: LocalParams):
    """``(params, rows [N, C]) -> logits [N, V]``, the head of TP-placed
    params with the vocabulary gathered (the JAX package's
    ``make_tp_head``): :func:`tp_head`, whose params carry their mesh."""
    return tp_head


def make_tp_forward(info: ModelInfo, mesh: Mesh, params: LocalParams, *, rescale=None,
                    full_output: bool = False, hooks: dict | None = None,
                    input_embeds: bool = False):
    """``(params, state, tokens, lengths) -> (out, new_state)``: the
    tensor- and data-parallel forward of this rank.

    ``params`` come from :func:`shard_params_tp` or
    ``sharding.shard_params`` (either plan), ``state`` from
    ``sharding.shard_state``. ``tokens`` ``[B, T]`` (``input_embeds``:
    ``[B, T, C]`` embeddings) and ``lengths`` ``[B]`` are the whole
    batch, as every rank is given them; each rank runs its lanes.
    ``out`` is every lane's last-token logits ``[B, V]`` or, with
    ``full_output``, the residual stream ``[B, T, C]``, gathered over
    ``data`` on every rank; ``new_state`` is this rank's shard.

    ``hooks`` tap every layer; inside the forward they see this rank's
    tensors, as the JAX package's ``shard_map`` taps do: the local lanes,
    and the local ``model`` slice of output-side channel dims (time-mix
    output, FFN hidden, logits).
    """
    if info.version not in ATT_SLICES:
        raise UnsupportedFeature(f"shard_map TP: unsupported version {info.version}")
    check_divides(info, mesh.shape["model"])
    kw = dict(rescale=rescale, hooks=hooks)

    def fwd(params, state, tokens, lengths):
        lanes = data_sharding(mesh, lengths.shape[0])
        ln = lengths[lanes]
        if input_embeds:
            x, new_state = forward_chunk(params.info, params, state, None, ln,
                                         input_embeds=tokens[lanes], **kw)
        else:
            x, new_state = forward_chunk(params.info, params, state, tokens[lanes], ln, **kw)
        if full_output:
            return all_gather(mesh, "data", x, dim=0), new_state
        idx = torch.clamp(ln - 1, 0, x.shape[1] - 1)
        rows = x[torch.arange(x.shape[0], device=x.device), idx]
        return all_gather(mesh, "data", tp_head(params, rows, hooks), dim=0), new_state

    return fwd
