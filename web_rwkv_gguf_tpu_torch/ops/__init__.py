"""Plain PyTorch ops (``basic``, ``wkv``) and the CUDA kernels (``cuda``)."""

from .basic import (  # noqa: F401
    group_norm,
    l2_normalize,
    layer_norm,
    lerp,
    rms_norm,
    squared_relu,
    stable_exp,
    token_shift,
)
from .wkv import wkv4, wkv6, wkv7_act_w, wkv7_step  # noqa: F401
