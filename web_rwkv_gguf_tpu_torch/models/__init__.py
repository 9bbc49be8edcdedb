"""RWKV-7, -6, -5 and -4 models: metadata, weight matrices, loader, forward, generation."""

from .info import ModelInfo, ModelVersion, detect_info  # noqa: F401
from .matrix import Matrix  # noqa: F401
from .loader import (  # noqa: F401
    LoraPatch,
    dense_cache_bytes,
    densify_matrices,
    group_gemv_matrices,
    load_initial_state,
    load_model,
    prepare_decode,
    unroll_params,
)
from .carry import params_from_numpy  # noqa: F401
from .forward import embed_tokens, forward_chunk, init_state, logits_head  # noqa: F401
from .generate import make_generator, make_sampler  # noqa: F401
