"""RWKV world-vocab byte-level tokenizer (greedy longest match).

Vocabulary format: a JSON object mapping token-id (as string or int) to
either a string or a byte list. Encoding greedily matches the longest
token; candidate lengths are indexed by the first two bytes so the match
loop only probes lengths that actually occur (ref: src/tokenizer.rs).
The hot loop runs in C++ (``native/tokenizer.cpp``); :meth:`Tokenizer._encode_py`
is the same matcher in Python, the reference the tests hold it against.
"""

from __future__ import annotations

import json
from pathlib import Path

from .. import native
from ..errors import TokenizerError  # noqa: F401 (re-export)


class Tokenizer:
    def __init__(self, vocab: str | dict):
        data = json.loads(vocab) if isinstance(vocab, str) else vocab

        entries: list[tuple[bytes, int]] = []
        for token_id, pattern in data.items():
            b = pattern.encode("utf-8") if isinstance(pattern, str) else bytes(pattern)
            entries.append((b, int(token_id)))

        # None only where the machine has no g++ (native.get_lib warns);
        # the Python matcher below then encodes
        self._native = native.build_vocab(entries)

        max_id = max((tid for _, tid in entries), default=0)
        self._id_to_bytes: list[bytes] = [b""] * (max_id + 1)
        self._bytes_to_id: dict[bytes, int] = {}
        # first two bytes → sorted (desc) tuple of candidate token lengths
        lengths: dict[int, set[int]] = {}
        for b, tid in entries:
            self._bytes_to_id[b] = tid
            self._id_to_bytes[tid] = b
            if len(b) >= 2:
                key = b[0] | (b[1] << 8)
                lengths.setdefault(key, set()).add(len(b))
        self._first_two_to_lengths = {
            k: tuple(sorted(v | {1}, reverse=True)) for k, v in lengths.items()
        }

    @classmethod
    def from_file(cls, path: str | Path) -> "Tokenizer":
        return cls(Path(path).read_text(encoding="utf-8"))

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_bytes)

    def encode(self, text: str | bytes) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        if self._native is not None:
            try:
                return self._native.encode(data).tolist()
            except ValueError as e:
                raise TokenizerError(str(e)) from None
        return self._encode_py(data)

    def _encode_py(self, data: bytes) -> list[int]:
        """The greedy matcher in Python (the native encoder's reference)."""
        out: list[int] = []
        pos = 0
        n = len(data)
        while pos < n:
            if pos + 1 < n:
                key = data[pos] | (data[pos + 1] << 8)
                candidates = self._first_two_to_lengths.get(key, (1,))
            else:
                candidates = (1,)
            for length in candidates:
                if pos + length > n:
                    continue
                tid = self._bytes_to_id.get(data[pos : pos + length])
                if tid is not None:
                    out.append(tid)
                    pos += length
                    break
            else:
                raise TokenizerError(
                    f"no matching token at byte offset {pos} ({data[pos:pos+8]!r})"
                )
        return out

    def decode(self, tokens) -> bytes:
        out = bytearray()
        for t in tokens:
            t = int(t)
            if t < 0 or t >= len(self._id_to_bytes):
                raise TokenizerError(f"out of range token: {t}")
            out.extend(self._id_to_bytes[t])
        return bytes(out)

    def decode_str(self, tokens, errors: str = "replace") -> str:
        return self.decode(tokens).decode("utf-8", errors=errors)
