"""Model snapshots: save a loaded (possibly requantized) parameter tree and
load it back without requantizing.

The reference serializes its quantized ``Model`` and reloads it as it is
(examples/serde.rs, src/tensor/serialization.rs:49-159). A snapshot is
the JAX package's ``.rwkvz`` schema: an ``.npz`` whose members are the
tree's arrays under ``path/leaf`` keys, with a ``__manifest__.json``
member holding ``version`` 1, the ``ModelInfo`` and the manifest (each
path's type: ``matrix`` with its kind and shape, ``dict`` with its keys,
``array`` with its dtype; bf16 arrays stored as their uint16 bits, named
in ``bf16``). The port adds one type, ``list`` with its length, for
per-layer blocks (``load_model(quant={layer: scheme})``), which the JAX
package's writer does not handle.

Only the port's own Matrix arrays are written: never the JAX package's
TPU operands (``models.carry.TPU_MATRIX_KEYS``), the whole-stack decode
blocks (``mega7``, ``mega56``) or the grouped gemv operands
(``Wrkv_g``), which ``models.prepare_decode`` / ``unroll_params`` rebuild.
A file the JAX package wrote loads through the same key filter as
``models.params_from_numpy``.
"""

from __future__ import annotations

import io
import json
import zipfile
from dataclasses import asdict

import numpy as np
import torch

from ..models.carry import TPU_MATRIX_KEYS, TPU_PARAM_KEYS
from ..models.info import CustomInfo, ModelInfo, ModelVersion
from ..models.matrix import Matrix

_MANIFEST = "__manifest__.json"
# arrays a snapshot never holds: the JAX package's gemv tiling operands
# ("st", "mnt" among them) and the decode blocks the port rebuilds
_SKIP_MATRIX = TPU_MATRIX_KEYS
_SKIP_PARAM = TPU_PARAM_KEYS | {"Wrkv_g"}


def _host(t) -> tuple[np.ndarray, bool]:
    """A numpy copy of a tensor or array, and whether it holds bf16 bits
    (then as uint16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), True
    return a, False


def _flatten(tree, prefix, arrays, manifest):
    if isinstance(tree, Matrix):
        entry = {"type": "matrix", "kind": tree.kind, "shape": list(tree.shape)}
        manifest[prefix] = entry
        for k, v in tree.arrays.items():
            if k in _SKIP_MATRIX:
                continue
            arr, bf16 = _host(v)
            if bf16:
                entry.setdefault("bf16", []).append(k)
            arrays[f"{prefix}/{k}"] = arr
    elif isinstance(tree, dict):
        keys = sorted(k for k in tree if k not in _SKIP_PARAM)
        manifest[prefix] = {"type": "dict", "keys": keys}
        for k in keys:
            _flatten(tree[k], f"{prefix}/{k}", arrays, manifest)
    elif isinstance(tree, list):
        manifest[prefix] = {"type": "list", "len": len(tree)}
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", arrays, manifest)
    else:
        arr, bf16 = _host(tree)
        entry = {"type": "array", "dtype": "bfloat16" if bf16 else str(arr.dtype)}
        if bf16:
            entry["bf16"] = True
        manifest[prefix] = entry
        arrays[prefix] = arr


def _tensor(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a.view(np.int16) if bf16 else a))
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def _unflatten(prefix, arrays, manifest, device):
    entry = manifest[prefix]
    kind = entry["type"]
    if kind == "matrix":
        bf16 = set(entry.get("bf16", []))
        pfx = prefix + "/"
        return Matrix(entry["kind"], tuple(entry["shape"]), {
            k[len(pfx):]: _tensor(arrays[k], k[len(pfx):] in bf16, device)
            for k in arrays.files
            if k.startswith(pfx) and "/" not in k[len(pfx):]
            and k[len(pfx):] not in _SKIP_MATRIX})
    if kind == "dict":
        return {k: _unflatten(f"{prefix}/{k}", arrays, manifest, device)
                for k in entry["keys"] if k not in _SKIP_PARAM}
    if kind == "list":
        return [_unflatten(f"{prefix}/{i}", arrays, manifest, device)
                for i in range(entry["len"])]
    return _tensor(arrays[prefix], bool(entry.get("bf16")), device)


def save_model(path, info: ModelInfo, params: dict):
    """Write ``params`` (from ``models.load_model``, on any device) and
    ``info`` to a ``.rwkvz`` snapshot at ``path``."""
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, dict] = {}
    _flatten(params, "params", arrays, manifest)
    custom = asdict(info.custom)
    meta = {
        "version": 1,
        "info": {"version": info.version.value, "num_layer": info.num_layer,
                 "num_emb": info.num_emb, "num_hidden": info.num_hidden,
                 "num_vocab": info.num_vocab, "num_head": info.num_head, "custom": custom},
        "manifest": manifest,
    }
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    with zipfile.ZipFile(path, "a") as z:
        z.writestr(_MANIFEST, json.dumps(meta))


def load_model_snapshot(path, device="cuda"):
    """``(info, params)`` from a ``.rwkvz`` snapshot (the port's or the JAX
    package's), the params on ``device`` as ``models.load_model`` gives
    them: the stored arrays, nothing requantized."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read(_MANIFEST))
    mi = meta["info"]
    info = ModelInfo(version=ModelVersion(mi["version"]), num_layer=mi["num_layer"],
                     num_emb=mi["num_emb"], num_hidden=mi["num_hidden"],
                     num_vocab=mi["num_vocab"], num_head=mi["num_head"],
                     custom=CustomInfo(**mi["custom"]))
    with np.load(path) as arrays:
        params = _unflatten("params", arrays, meta["manifest"], device)
    return info, params
