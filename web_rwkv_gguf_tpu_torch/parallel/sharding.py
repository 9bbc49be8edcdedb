"""Meshes of ranks, their collectives, and the placement of parameters and
recurrent state on them.

The port of the JAX package's ``parallel/sharding.py``. JAX drives every
device of a mesh from one process; PyTorch runs one process a rank. So
the port works as ``shard_map`` does: every rank builds the same objects
from the same arguments, keeps only its own shard, and meets the other
ranks in explicit collectives of ``torch.distributed``.

:class:`Mesh` names its axes (``{"data": n_data, "model": n_model}`` for
serving, ``{"pp": S}`` for the pipelined decode), places rank r at the
row-major coordinates of r, and holds one process group per axis: every
rank creates every group, in the same order. A mesh of one rank needs no
process group, and each of its collectives is the identity (as the JAX
package's ``_broadcast`` is on one process).

The backend is the caller's choice (:func:`multihost_initialize`): NCCL
where ranks sit on distinct CUDA devices, gloo on the CPU or where
several ranks share one card. Gloo is handed host tensors: a CUDA tensor
crosses it through a host copy, made in one place
(:func:`comm_tensor`) and only under gloo.

Placement, per rank, as pure functions of ``(rank, n)``:

- lanes on ``data`` (:func:`data_sharding`, :func:`shard_state`);
- WKV heads (RWKV-4: its ``aa``/``bb``/``pp`` channels) on ``model``;
  token-shift rows replicated over ``model``;
- column-parallel matrices (output rows M) split on ``model`` by
  :func:`col_shard`; row-parallel ones (the contraction K) by
  :func:`row_shard`, where :func:`row_shardable` says the split is whole.

The JAX package splits K on its repacked per-32-group arrays. The port
keeps the GGML super-blocks (a Q4_K row's 6-bit factors and its per-256
super-scales), so a K-split is whole only where each rank's
``K / n_model`` holds whole units of :func:`k_block` (256 for the
K-quants' native factors). Where it is not (Q4_K ``Wo`` at C = 768 over
two ranks: 384 = 1.5 super-blocks), the plan of :func:`shard_params`
replicates the matrix and gathers its input instead: another placement
than the JAX package's, the same function.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..errors import EngineError
from ..models.matrix import Matrix

# wall seconds, calls and bytes of every collective this process made (a
# gloo call includes its host copies); chip_smoke.py reads and zeroes it
COMM_STATS = {"seconds": 0.0, "calls": 0, "bytes": 0}


def multihost_initialize(**kwargs):
    """Join the process group: ``torch.distributed.init_process_group``
    from the keyword arguments, or from the ``MASTER_ADDR`` / ``RANK`` /
    ``WORLD_SIZE`` environment (``init_method="env://"``). ``backend``
    defaults to NCCL where CUDA is available, else gloo; pass
    ``backend="gloo"`` for ranks that share one card. ``timeout`` may be
    seconds or a ``timedelta``. Without keyword arguments or those
    variables it does nothing (one process, as the JAX package's
    ``multihost_initialize``)."""
    if dist.is_initialized():
        return
    if not kwargs and not os.environ.get("MASTER_ADDR"):
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    if "init_method" not in kwargs:
        kwargs["init_method"] = "env://"
        kwargs.setdefault("rank", int(os.environ["RANK"]))
        kwargs.setdefault("world_size", int(os.environ["WORLD_SIZE"]))
    timeout = kwargs.get("timeout")
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(**kwargs)


def world() -> tuple[int, int]:
    """``(rank, world_size)`` of this process; ``(0, 1)`` without a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Named axes over the ranks of the process group.

    ``shape`` maps axis names to sizes (their product is the world size);
    rank r sits at the row-major coordinates of r (for ``{"data": D,
    "model": M}``: ``(r // M, r % M)``). ``device`` is where this rank
    computes: ``"cuda"`` (default) means the card ``rank % device_count``,
    so ranks of one host take distinct cards where there are enough and
    share the card where there is one."""

    def __init__(self, shape: dict, device="cuda"):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.rank, self.size = world()
        if int(np.prod(list(self.shape.values()))) != self.size:
            raise EngineError(f"a mesh {self.shape} needs {int(np.prod(list(self.shape.values())))} "
                              f"ranks; the process group has {self.size}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", self.rank % max(1, torch.cuda.device_count()))
        self.device = device
        names, sizes = list(self.shape), list(self.shape.values())
        self.coords = dict(zip(names, np.unravel_index(self.rank, sizes)))
        self.coords = {k: int(v) for k, v in self.coords.items()}
        self._groups = {}
        grid = np.arange(self.size).reshape(sizes)
        for i, axis in enumerate(names):
            # every rank creates every group of the axis in the same order
            lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if self.rank in ranks:
                    self._groups[axis] = (group, ranks)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        """``(process group or None, its global ranks)`` of this rank along
        ``axis``; None for an axis of one rank."""
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def make_mesh(n_data: int | None = None, n_model: int | None = None, *,
              device="cuda") -> Mesh:
    """A ``(data, model)`` mesh over the process group's ranks (the JAX
    package's ``make_mesh``): with neither size given every rank is on
    ``model``; one size given, the other is what the world leaves."""
    n = world()[1]
    if n_data is None and n_model is None:
        n_data, n_model = 1, n
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    return Mesh({"data": n_data, "model": n_model}, device=device)


# -- collectives -------------------------------------------------------------


def comm_tensor(t: torch.Tensor, device=None) -> torch.Tensor:
    """The tensor a collective is handed on this backend: under gloo a
    host copy of a CUDA tensor (the one place the port copies through the
    host), under NCCL a copy of a host tensor on ``device``; else ``t``."""
    backend = dist.get_backend()
    if backend == "gloo" and t.is_cuda:
        return t.cpu()
    if backend == "nccl" and not t.is_cuda:
        return t.to(device if device is not None else torch.device("cuda"))
    return t


def _timed(fn, nbytes):
    t0 = time.perf_counter()
    out = fn()
    COMM_STATS["seconds"] += time.perf_counter() - t0
    COMM_STATS["calls"] += 1
    COMM_STATS["bytes"] += nbytes
    return out


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim`` in axis
    order (JAX's tiled ``all_gather``); ``t`` itself on an axis of one."""
    group, ranks = mesh.group(axis)
    if group is None:
        return t

    def run():
        src = comm_tensor(t.contiguous(), mesh.device)
        outs = [torch.empty_like(src) for _ in ranks]
        dist.all_gather(outs, src, group=group)
        return torch.cat(outs, dim).to(t.device)

    return _timed(run, t.numel() * t.element_size() * len(ranks))


def all_reduce(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' ``t`` along ``axis`` (JAX's ``psum``)."""
    group, ranks = mesh.group(axis)
    if group is None:
        return t

    def run():
        src = comm_tensor(t.contiguous(), mesh.device)
        if src is t:
            src = src.clone()
        dist.all_reduce(src, group=group)
        return src.to(t.device)

    return _timed(run, t.numel() * t.element_size() * len(ranks))


def broadcast(t: torch.Tensor, src: int = 0, *, group=None, device=None) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group`` (default:
    the world); the identity without a process group of two or more."""
    if world()[1] == 1:
        return t

    def run():
        buf = comm_tensor(t.contiguous(), device)
        if buf is t:
            buf = buf.clone()
        dist.broadcast(buf, src, group=group)
        return buf.to(t.device)

    return _timed(run, t.numel() * t.element_size())


def send(t: torch.Tensor, dst: int, *, device=None):
    """Start sending ``t`` to global rank ``dst``; returns the handle to
    wait on (the tensor handed over must live until then)."""
    buf = comm_tensor(t.contiguous(), device)
    work = _timed(lambda: dist.isend(buf, dst), t.numel() * t.element_size())
    return work, buf


def recv(like: torch.Tensor, src: int, *, device=None) -> torch.Tensor:
    """A tensor shaped as ``like`` received from global rank ``src``, on
    ``like``'s device."""
    buf = comm_tensor(torch.empty_like(like), device)
    _timed(lambda: dist.recv(buf, src), like.numel() * like.element_size())
    return buf.to(like.device)


# -- placement ---------------------------------------------------------------


def data_sharding(mesh: Mesh, num_batch: int) -> slice:
    """The lanes of a ``[B, ...]`` token block, a ``[B]`` length vector or
    a state's lane axis that this rank holds (``data`` splits them in
    order)."""
    n = mesh.shape.get("data", 1)
    if num_batch % n:
        raise EngineError(f"num_batch {num_batch} must divide by the data axis ({n})")
    per = num_batch // n
    d = mesh.coords.get("data", 0)
    return slice(d * per, (d + 1) * per)


def _split(a: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = a.shape[dim] // n
    return a.narrow(dim, rank * size, size).contiguous()


# state keys split on model (dim 2 of [L, B, ...]): the WKV heads, RWKV-4's
# per-channel state; the token-shift rows stay whole
_MODEL_STATE = ("wkv", "aa", "bb", "pp")


def shard_heads(state: dict, mesh: Mesh) -> dict:
    """``state`` ``[L, B, ...]`` with its WKV heads or RWKV-4 channels cut
    to this rank's on ``model`` (every lane kept); copies on the mesh's
    device."""
    n, m = mesh.shape.get("model", 1), mesh.coords.get("model", 0)
    return {k: (_split(a, 2, m, n) if k in _MODEL_STATE and n > 1 else a)
            .to(mesh.device).contiguous() for k, a in state.items()}


def shard_state(state: dict, mesh: Mesh) -> dict:
    """This rank's shard of a whole ``[L, B, ...]`` state: its lanes
    (:func:`data_sharding`), and its WKV heads or RWKV-4 channels on
    ``model``; copies on the mesh's device."""
    lanes = data_sharding(mesh, next(iter(state.values())).shape[1])
    return shard_heads({k: a[:, lanes] for k, a in state.items()}, mesh)


def gather_state(state: dict, mesh: Mesh) -> dict:
    """The inverse of :func:`shard_state`: the whole ``[L, B, ...]`` state
    on every rank, gathered over ``model`` and then over ``data``."""
    out = {}
    for k, a in state.items():
        if k in _MODEL_STATE and "model" in mesh.shape:
            a = all_gather(mesh, "model", a, dim=2)
        if "data" in mesh.shape:
            a = all_gather(mesh, "data", a, dim=1)
        out[k] = a
    return out


def k_block(mat: Matrix) -> int:
    """The K-structure unit of a matrix: the contraction elements that one
    slice of its arrays must hold whole. Dense 1; the K-quants' native
    factors (``sc6``/``d8``, ``q6s``/``q6d``) a 256-element super-block;
    Int8 128; NF4 / SF4 64 (absmax); f32 group scales their group, twice
    it for split-halves nibbles (``qk``), whose halves must stay
    group-aligned."""
    if mat.kind == "dense":
        return 1
    a = mat.arrays
    if "sc6" in a or "q6s" in a:
        return 256
    if mat.kind == "int8":
        return 128
    if mat.kind == "nf4":
        return 64
    group = mat.dims()[1] // a["scales"].shape[-1]
    return 2 * group if mat.kind == "qk" else group


def row_shardable(mat: Matrix, n: int) -> bool:
    """Whether ``mat`` splits its contraction K over n ranks in whole
    :func:`k_block` units (the row-parallel placement)."""
    k = mat.dims()[1]
    return k % n == 0 and (k // n) % k_block(mat) == 0


def col_shardable(mat: Matrix, n: int) -> bool:
    """Whether ``mat`` splits its output rows M over n ranks: every kind
    keeps its rows independent, so wherever n divides M."""
    return mat.dims()[0] % n == 0


def col_shard(mat: Matrix, rank: int, n: int) -> Matrix:
    """Rows ``rank·M/n : (rank+1)·M/n`` of a (layer-stacked) matrix,
    copied (the column-parallel placement; an NF4 codebook stays whole).
    One rank keeps ``mat`` itself."""
    if n == 1:
        return mat
    m, k = mat.dims()
    arrays = {key: (a if key == "lut" else _split(a, a.dim() - 2, rank, n))
              for key, a in mat.arrays.items()}
    return Matrix(mat.kind, (m // n, k), arrays)


def row_shard(mat: Matrix, rank: int, n: int) -> Matrix:
    """Contraction elements ``rank·K/n : (rank+1)·K/n`` of a (layer-stacked)
    matrix, copied (the row-parallel placement); :func:`row_shardable`
    must hold. Every array whose last axis runs along K is cut in
    proportion; split-halves nibble codes (``qk``: byte j holds elements
    j and j + K/2) are unpacked, cut and packed again over the local
    halves. One rank keeps ``mat`` itself."""
    if not row_shardable(mat, n):
        raise EngineError(f"{mat.kind} [{mat.dims()}] does not split K over {n} ranks "
                          f"in whole units of {k_block(mat)}")
    if n == 1:
        return mat
    m, k = mat.dims()
    arrays = {}
    for key, a in mat.arrays.items():
        if key == "lut":
            arrays[key] = a
        elif key == "codes" and mat.kind == "qk":
            full = torch.cat([a & 0x0F, a >> 4], dim=-1)
            part = _split(full, full.dim() - 1, rank, n)
            half = part.shape[-1] // 2
            arrays[key] = (part[..., :half] | (part[..., half:] << 4)).contiguous()
        else:
            arrays[key] = _split(a, a.dim() - 1, rank, n)
    return Matrix(mat.kind, (m, k // n), arrays)


def shard_params(params: dict, mesh: Mesh, info) -> dict:
    """This rank's parameters under the column/row plan (the JAX package's
    GSPMD plan, its psums made explicit): column-parallel att
    Wr/Wk/Wv/Wg, FFN Wk and the head; row-parallel att Wo, FFN Wv and
    (RWKV-6, -5, -4) the FFN receptance, each product followed by one
    ``all_reduce`` over ``model``; small tensors replicated, the
    output-side per-head vectors cut to this rank's heads. A row-parallel
    matrix that does not split K whole (:func:`row_shardable`) stays whole
    and gathers its input. See ``parallel/tensor.py``."""
    from .tensor import place_params

    return place_params(params, mesh, info, "gspmd")
