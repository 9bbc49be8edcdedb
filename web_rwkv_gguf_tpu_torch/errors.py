"""Typed error taxonomy, mirroring the reference's error enums
(ref: src/runtime/gguf.rs:862-878 GgufError, src/runtime/loader.rs:28-40
LoaderError, src/runtime/mod.rs:70-82 RuntimeError,
src/tensor/mod.rs:128-153 TensorError/TensorErrorKind,
src/tokenizer.rs:8 TokenizerError).

Every class also inherits the builtin exception callers historically
caught (ValueError / KeyError / NotImplementedError), so typed raises
are a refinement, never a compatibility break: ``except ValueError``
still catches a :class:`TensorError`, while new code can catch
:class:`WebRwkvError` to get everything this library raises on purpose.
"""

from __future__ import annotations


class WebRwkvError(Exception):
    """Root of every intentional error raised by this library."""


class GgufError(WebRwkvError, ValueError):
    """Malformed or unsupported GGUF content (ref: GgufError)."""


class TensorNotFound(GgufError, KeyError):
    """Named tensor absent from the file (ref: GgufError::TensorNotFound).

    KeyError subclass: lookup sites historically raised KeyError.
    """

    def __str__(self):  # KeyError quotes its arg; keep the message plain
        return ValueError.__str__(self)


class UnsupportedTensorType(GgufError):
    """Tensor dtype this build cannot decode
    (ref: GgufError::UnsupportedTensorType)."""


class TokenizerError(WebRwkvError, ValueError):
    """Vocab parse / encode / decode failure (ref: TokenizerError)."""


class LoaderError(WebRwkvError, ValueError):
    """Checkpoint-to-model assembly failure (ref: LoaderError)."""


class InvalidVersion(LoaderError):
    """Model version undetectable or unsupported
    (ref: LoaderError::InvalidVersion)."""


class TensorError(WebRwkvError, ValueError):
    """Shape/size/batch mismatch between tensors or against the model
    (ref: TensorError with TensorErrorKind). ``kind`` is one of
    'empty' | 'type' | 'size' | 'batch' | 'shape' | 'slice'."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind

    @classmethod
    def size(cls, got, want) -> "TensorError":
        return cls("size", f"data size not match: {got} vs. {want}")

    @classmethod
    def batch(cls, got, want) -> "TensorError":
        return cls("batch", f"batch size not match: {got} vs. {want}")

    @classmethod
    def shape(cls, got, want) -> "TensorError":
        return cls("shape", f"tensor shape not match: {got} vs. {want}")


class EngineError(WebRwkvError, ValueError):
    """Runtime/scheduler failure (ref: RuntimeError)."""


class InputExhausted(EngineError):
    """Inference driven past the end of its input
    (ref: RuntimeError::InputExhausted)."""


class UnsupportedFeature(WebRwkvError, NotImplementedError):
    """A deliberate feature gate (e.g. a parallelism mode that only
    supports some model versions) — not an accidental stub."""
