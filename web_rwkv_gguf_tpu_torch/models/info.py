"""Model version detection and metadata."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..errors import InvalidVersion


class ModelVersion(enum.Enum):
    V4 = "v4"
    V5 = "v5"
    V6 = "v6"
    V7 = "v7"


PAD_VEC = 8  # vector length padding (ref: loader.rs:24)
PAD_MAT = 8  # matrix dim padding (ref: loader.rs:25)


@dataclass
class CustomInfo:
    """Inner-LoRA adapter dims (ref: v6.rs CustomInfo, v7.rs CustomInfo)."""

    time_mix: int = 0  # v6 ddlerp rank (per each of 5 mixes)
    time_decay: int = 0  # v6 decay rank
    w: int = 0  # v7 decay rank
    a: int = 0  # v7 iclr rank
    g: int = 0  # v7 gate rank
    v: int = 0  # v7 value-residual rank


@dataclass
class ModelInfo:
    version: ModelVersion
    num_layer: int
    num_emb: int
    num_hidden: int
    num_vocab: int
    num_head: int
    custom: CustomInfo = field(default_factory=CustomInfo)

    @property
    def head_size(self) -> int:
        return self.num_emb // self.num_head

    @property
    def num_vocab_padded(self) -> int:
        """Vocab padded to a multiple of PAD_MAT (ref: model.rs:60-62)."""
        return -(-self.num_vocab // PAD_MAT) * PAD_MAT


_V4_NAMES = [
    "blocks.0.att.time_decay",
    "blocks.0.att.time_first",
    "blocks.0.att.time_mix_k",
    "blocks.0.att.time_mix_v",
    "blocks.0.att.time_mix_r",
]
_V5_NAMES = [
    "blocks.0.att.gate.weight",
    "blocks.0.att.ln_x.weight",
    "blocks.0.att.ln_x.bias",
]
_V6_NAMES = [
    "blocks.0.att.time_mix_x",
    "blocks.0.att.time_mix_w",
    "blocks.0.att.time_mix_k",
    "blocks.0.att.time_mix_v",
    "blocks.0.att.time_mix_r",
    "blocks.0.att.time_mix_g",
    "blocks.0.att.time_mix_w1",
    "blocks.0.att.time_mix_w2",
    "blocks.0.att.time_decay_w1",
    "blocks.0.att.time_decay_w2",
    "blocks.0.ffn.time_mix_k",
    "blocks.0.ffn.time_mix_r",
]
_V7_SEPARATE = [
    "blocks.0.att.x_r",
    "blocks.0.att.x_w",
    "blocks.0.att.x_k",
    "blocks.0.att.x_v",
    "blocks.0.att.x_a",
    "blocks.0.att.x_g",
    "blocks.0.att.w0",
    "blocks.0.att.w1",
    "blocks.0.att.w2",
    "blocks.0.att.a0",
    "blocks.0.att.a1",
    "blocks.0.att.a2",
    "blocks.0.att.g1",
    "blocks.0.att.g2",
    "blocks.0.att.r_k",
    "blocks.0.att.k_k",
    "blocks.0.att.k_a",
]
_V7_FUSED = [
    "blocks.0.att.time_maa",
    "blocks.0.att.w0",
    "blocks.0.att.w1",
    "blocks.0.att.w2",
    "blocks.0.att.a0",
    "blocks.0.att.a1",
    "blocks.0.att.a2",
    "blocks.0.att.g1",
    "blocks.0.att.g2",
    "blocks.0.att.r_k",
    "blocks.0.att.k_k",
    "blocks.0.att.k_a",
]


def detect_info(reader) -> ModelInfo:
    """Probe tensor names to determine the model version and dimensions.

    ``reader`` follows the GgufFile API: names()/contains()/shape().
    """
    num_layer = 0
    for name in reader.names():
        if name.startswith("blocks."):
            rest = name[len("blocks.") :]
            dot = rest.find(".")
            if dot > 0:
                try:
                    num_layer = max(num_layer, int(rest[:dot]))
                except ValueError:
                    pass
    num_layer += 1

    embed = reader.shape("emb.weight")
    ffn = reader.shape("blocks.0.ffn.key.weight")

    has = reader.contains
    v4 = all(has(n) for n in _V4_NAMES)
    v5 = all(has(n) for n in _V5_NAMES)
    v6 = all(has(n) for n in _V6_NAMES)
    v7 = all(has(n) for n in _V7_SEPARATE) or all(has(n) for n in _V7_FUSED)

    if v7:
        version = ModelVersion.V7
    elif v6:
        version = ModelVersion.V6
    elif v5:
        version = ModelVersion.V5
    elif v4:
        version = ModelVersion.V4
    else:
        raise InvalidVersion("unable to detect model version from tensor names")

    num_emb = embed[1]
    num_hidden = ffn[0]
    num_vocab = embed[0]

    if version == ModelVersion.V4:
        num_head = 1
    elif version in (ModelVersion.V5, ModelVersion.V6):
        num_head = reader.shape("blocks.0.att.time_first")[0]
    else:
        num_head = reader.shape("blocks.0.att.r_k")[0]

    custom = CustomInfo()
    if version == ModelVersion.V6:
        custom.time_mix = reader.shape("blocks.0.att.time_mix_w1")[0] // 5
        custom.time_decay = reader.shape("blocks.0.att.time_decay_w1")[0]
    elif version == ModelVersion.V7:
        custom.w = reader.shape("blocks.0.att.w1")[0]
        custom.a = reader.shape("blocks.0.att.a1")[0]
        custom.g = reader.shape("blocks.0.att.g1")[0]
        if num_layer > 1 and reader.contains("blocks.1.att.v1"):
            custom.v = reader.shape("blocks.1.att.v1")[0]

    return ModelInfo(
        version=version,
        num_layer=num_layer,
        num_emb=num_emb,
        num_hidden=num_hidden,
        num_vocab=num_vocab,
        num_head=num_head,
        custom=custom,
    )
