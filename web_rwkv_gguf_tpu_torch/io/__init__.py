"""Model and state files.

Ref: src/tensor/serialization.rs and examples/serde.rs (save a
prequantized model and load it back without requantizing), the State
back/load pair (src/runtime/model.rs:89-100) and the safetensors loader
(src/runtime/loader.rs), as the JAX package's ``io`` ports them: ``.rwkvz``
model snapshots, ``.npz`` state files in either package's hands, the
reference's state layout, and ``.safetensors`` reading and writing.
"""

from .safetensors import SafetensorsFile, write_safetensors  # noqa: F401
from .snapshot import load_model_snapshot, save_model  # noqa: F401
from .state import (  # noqa: F401
    load_state,
    save_state,
    state_from_reference_layout,
    state_to_reference_layout,
)
