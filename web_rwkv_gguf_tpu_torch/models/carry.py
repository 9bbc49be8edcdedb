"""Carry a parameter tree given as numpy arrays into the port's form.

The JAX package's ``load_model`` returns a tree of dicts, lists, arrays
and ``Matrix`` objects; after ``jax.device_get`` (or ``np.asarray`` on
each leaf) every array is numpy. :func:`params_from_numpy` turns such a
tree into the port's tree of torch tensors, so tests can feed both
packages identical weights. It needs no import of the JAX package: any
object with ``kind``, ``shape`` and ``arrays`` is taken for a matrix.

Arrays that only lay weights out for the TPU's kernels are dropped: the
packed gemv operands of a matrix (:data:`TPU_MATRIX_KEYS`) and the
whole-stack and grouped decode blocks, plus the stacked LoRA copies
(:data:`TPU_PARAM_KEYS`). The grouped r/k/v operands ``Wrkv_g`` are the
TPU kernel's layout (row-concatenated codes, position-interleaved
scales); the port rebuilds its own from the carried matrices with
``loader.unroll_params``, as it rebuilds the whole-stack blocks with
``loader.prepare_decode``.
"""

from __future__ import annotations

import numpy as np
import torch

from .matrix import Matrix

TPU_MATRIX_KEYS = frozenset(
    {"stq", "mnq", "sd", "sdm", "scq", "sdn", "st", "mnt"})
TPU_PARAM_KEYS = frozenset({"Wrkv_g", "mega7", "mega56", "lora_down", "lora_up"})


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree, device="cuda"):
    """The port's form of a parameter tree of numpy arrays (see module doc)."""
    if all(hasattr(tree, attr) for attr in ("kind", "shape", "arrays")):
        return Matrix(tree.kind, tuple(tree.shape),
                      {k: _tensor(a, device) for k, a in tree.arrays.items()
                       if k not in TPU_MATRIX_KEYS})
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()
                if k not in TPU_PARAM_KEYS}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _tensor(tree, device)
