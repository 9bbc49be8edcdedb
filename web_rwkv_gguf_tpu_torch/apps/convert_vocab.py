"""Convert an RWKV world-vocab .txt file to tokenizer JSON
(ref: assets/scripts/convert_tokenizer.py).

The .txt format is one entry per line: ``<id> <python-literal> <len>``
where the literal is a str or bytes.
"""

from __future__ import annotations

import argparse
import ast
import json


def convert(txt: str) -> dict:
    vocab = {}
    for line in txt.splitlines():
        line = line.strip()
        if not line:
            continue
        idx_s, rest = line.split(" ", 1)
        literal, _len = rest.rsplit(" ", 1)
        value = ast.literal_eval(literal)
        if isinstance(value, bytes):
            vocab[int(idx_s)] = list(value)
        else:
            vocab[int(idx_s)] = value
    return vocab


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="vocab .txt")
    p.add_argument("--output", required=True, help="vocab .json")
    args = p.parse_args(argv)
    vocab = convert(open(args.input, encoding="utf-8").read())
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    print(f"wrote {args.output}: {len(vocab)} tokens")


if __name__ == "__main__":
    main()
