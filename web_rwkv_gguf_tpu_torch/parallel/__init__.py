"""Serving across ranks: meshes, tensor and data parallelism, and the
pipelined whole-stack decode.

The port of the JAX package's ``parallel/``: one process a rank, each
holding its shard, with explicit ``torch.distributed`` collectives
(``sharding.py``). Quantized weights are cut over ``model`` (column- and
row-parallel pairs, ``tensor.py``), recurrent state over ``data`` with
the lanes and over ``model`` with the heads, and the decode's layer
stack over ``pp`` stages (``decode_pp.py``). A chunk's layer stack may
also run as a GPipe pipeline of microbatches over the stages
(``pipeline.py``), and a long chunk's tokens may be cut over the ranks
(``sequence.py``, the sequence-parallel prefill). ``launch.py`` starts
the ranks of one host.
"""

from .sharding import (  # noqa: F401
    Mesh,
    data_sharding,
    gather_state,
    make_mesh,
    multihost_initialize,
    shard_params,
    shard_state,
)
from .sequence import make_seq_parallel_prefill  # noqa: F401
from .tensor import make_tp_forward, make_tp_head, shard_params_tp  # noqa: F401
from .pipeline import make_pipeline_forward, pipeline_state  # noqa: F401
from .decode_pp import (  # noqa: F401
    PipelinedDecoder,
    greedy_scan_reference,
    make_pp_generator,
    make_pp_params,
    pp_state,
)
