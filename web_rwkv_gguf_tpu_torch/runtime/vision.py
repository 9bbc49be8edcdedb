"""Vision input: image patches in, the final embedding out (the JAX
package's ``runtime/vision.py``; ref: src/runtime/infer/vision.rs).

A picture is N patches shaped ``[X, Y, C, N]``; each patch flattens to
one input embedding of ``X·Y·C`` values (the model's ``num_emb``), and the
patches run through the model as one sequence. The output is the last
patch's residual stream (no head), as the reference's ``VisionOutput``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import TensorError
from ..models.forward import forward_chunk, init_state


@dataclass
class VisionInput:
    """Patch tensor ``[X, Y, C, N]`` (ref: vision.rs:26-59)."""

    patches: np.ndarray

    @property
    def num_patch(self) -> int:
        return self.patches.shape[3]

    @property
    def num_emb(self) -> int:
        x, y, c, _ = self.patches.shape
        return x * y * c


def infer_vision(info, params, input: VisionInput, state=None, *, device=None):
    """Run the patches through the model as one chunk of ``input_embeds``.
    Returns ``(embedding [num_emb] f32 numpy, new_state)``; ``state``
    (one lane, as ``init_state(info, 1)``) defaults to zeros on the
    params' device, or on ``device`` where given."""
    if input.num_emb != info.num_emb:
        raise TensorError.size(input.num_emb, info.num_emb)
    n = input.num_patch
    device = torch.device(device) if device is not None else params["emb"].device
    embeds = np.asarray(input.patches, np.float32).reshape(input.num_emb, n).T[None]
    state = state if state is not None else init_state(info, 1, device=device)
    x, state = forward_chunk(
        info, params, state, None, torch.tensor([n], device=device),
        input_embeds=torch.from_numpy(np.ascontiguousarray(embeds)).to(device))
    return x[0, n - 1].cpu().numpy(), state
