"""Recurrent-state files and the reference's state layout.

The reference stores one batch lane's state as one tensor ``[num_emb,
rows, num_layer]`` whose rows are, per version (x fastest):

- V4: ``[shift_x, aa, bb, pp, ffn_x]`` (5 rows, v4.rs:152-184);
- V5, V6, V7: ``[shift_x, S row 0 .. head_size - 1, ffn_x]`` (head_size +
  2 rows, S[j, c = h·hs + i] = the head's state[k = j, v = i],
  v7.rs:186-207).

:func:`state_to_reference_layout` gives that array as ``[L, rows, C]``.
:func:`save_state` / :func:`load_state` keep one lane's state (a
``runtime.Engine.back_state`` dict of numpy arrays) in an ``.npz`` file
with a ``__state_info__.json`` member, the JAX package's ``io/state.py``
format: each package reads the other's files.
"""

from __future__ import annotations

import json
import zipfile

import numpy as np

from ..models.info import ModelInfo, ModelVersion


def state_to_reference_layout(info: ModelInfo, snapshot: dict) -> np.ndarray:
    """One lane's state (``Engine.back_state``) as ``[L, rows, C]`` f32."""
    L, C, hs = info.num_layer, info.num_emb, info.head_size
    if info.version == ModelVersion.V4:
        out = np.zeros((L, 5, C), np.float32)
        for row, key in enumerate(("att_shift", "aa", "bb", "pp", "ffn_shift")):
            out[:, row] = snapshot[key]
        return out
    out = np.zeros((L, hs + 2, C), np.float32)
    out[:, 0] = snapshot["att_shift"]
    # wkv [L, H, K, V] → row j = k, channel c = h·hs + i (v)
    out[:, 1 : hs + 1] = np.asarray(snapshot["wkv"]).transpose(0, 2, 1, 3).reshape(L, hs, C)
    out[:, hs + 1] = snapshot["ffn_shift"]
    return out


def state_from_reference_layout(info: ModelInfo, data: np.ndarray) -> dict:
    """``[L, rows, C]`` → one lane's state for ``Engine.load_state``."""
    L, C, H, hs = info.num_layer, info.num_emb, info.num_head, info.head_size
    data = np.asarray(data, np.float32)
    if info.version == ModelVersion.V4:
        if data.shape != (L, 5, C):
            raise ValueError(f"a V4 state is [{L}, 5, {C}], not {list(data.shape)}")
        return {key: data[:, row]
                for row, key in enumerate(("att_shift", "aa", "bb", "pp", "ffn_shift"))}
    if data.shape != (L, hs + 2, C):
        raise ValueError(f"this state is [{L}, {hs + 2}, {C}], not {list(data.shape)}")
    wkv = data[:, 1 : hs + 1].reshape(L, hs, H, hs).transpose(0, 2, 1, 3)
    return {"att_shift": data[:, 0], "wkv": np.ascontiguousarray(wkv),
            "ffn_shift": data[:, hs + 1]}


def save_state(path, info: ModelInfo, snapshot: dict):
    """Save one lane's state (a chat in progress, say) to an ``.npz`` file."""
    np.savez(path, **{k: np.asarray(v) for k, v in snapshot.items()})
    with zipfile.ZipFile(path, "a") as z:
        z.writestr("__state_info__.json",
                   json.dumps({"version": info.version.value, "num_layer": info.num_layer}))


def load_state(path) -> dict:
    """One lane's state from a :func:`save_state` file."""
    data = np.load(path)
    return {k: data[k] for k in data.files if not k.startswith("__")}
