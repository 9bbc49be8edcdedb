"""Dump GGUF metadata and tensor info (ref: debug_gguf.rs)."""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model", help=".gguf file")
    p.add_argument("--tensors", action="store_true", help="list all tensors")
    p.add_argument("--detect", action="store_true", help="run version detection")
    p.add_argument("--stats", action="store_true",
                   help="per-tensor weight quantile statistics")
    args = p.parse_args(argv)

    from ..gguf import GgufFile

    f = GgufFile(args.model)
    print(f"gguf version: {f.version}")
    print(f"tensor count: {len(f.tensors)}")
    print(f"data offset:  {f.tensor_data_offset}")
    print("metadata:")
    for k, v in sorted(f.metadata.items()):
        s = str(v)
        if len(s) > 80:
            s = s[:77] + "..."
        print(f"  {k} = {s}")
    if args.tensors:
        print("tensors:")
        for name, info in sorted(f.tensors.items()):
            print(
                f"  {name:50} {str(tuple(info.dims)):>20} {info.dtype.name:>6} "
                f"@ {info.offset}"
            )
    if args.stats:
        import numpy as np

        from ..errors import GgufError
        from ..quant.formats import matrix_statistics

        print("statistics:")
        for name in sorted(f.tensors):
            try:
                st = matrix_statistics(f.tensor(name, np.float32))
            except GgufError:  # a type this build cannot decode
                continue
            print(f"  {name:50} " + " ".join(f"{k}={v:+.4f}" for k, v in st.items()))
    if args.detect:
        from ..models import detect_info

        print("detected:", detect_info(f))


if __name__ == "__main__":
    main()
