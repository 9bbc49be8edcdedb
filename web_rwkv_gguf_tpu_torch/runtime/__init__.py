"""Runtime: chunk scheduling and the inference engine.

Ref: src/runtime/mod.rs (Runtime trait) and src/runtime/infer/rnn.rs
(RnnInput / RnnIter / redirect), as the JAX package's ``runtime`` ports
them; ``EnginePool`` and the multi-device engines are later slices.
"""

from .scheduler import (  # noqa: F401
    MIN_TOKEN_CHUNK_SIZE,
    PlanBatch,
    RnnInput,
    RnnInputBatch,
    RnnIter,
    RnnOption,
    plan_chunk,
    redirect,
)
from .engine import Engine, RnnOutput, softmax  # noqa: F401
