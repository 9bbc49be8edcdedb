"""Runtime: chunk scheduling and the inference engine.

Ref: src/runtime/mod.rs (Runtime trait) and src/runtime/infer/rnn.rs
(RnnInput / RnnIter / redirect), as the JAX package's ``runtime`` ports
them: the scheduler, the ``Engine`` with its dense prefill and decode
weights and their policies, hooks and embedding input, ``EnginePool``,
and vision input (``VisionInput``, ``infer_vision``), serving across ranks
(``Engine(mesh=, tp_mode=)``) and the engine whose chunk plans every
rank agrees on (``DistributedEngine``, ``runtime/distributed.py``).
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
from .engine import (  # noqa: F401
    DECODE_DENSE_MIN_B,
    Engine,
    EnginePool,
    RnnOutput,
    auto_decode_dense,
    auto_prefill_dense,
    memory_limit,
    softmax,
)
from .vision import VisionInput, infer_vision  # noqa: F401
from .distributed import OP_STEP, OP_STOP, DistributedEngine  # noqa: F401
