"""Convert/prequantize a model to an engine snapshot (.rwkvz)
(ref: examples/serde.rs — save a prequantized model for fast reload)."""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    p.add_argument("--output", required=True, help="output .rwkvz path")
    args = p.parse_args(argv)

    from ..io import save_model

    info, params = common.load_any_model(args)
    t0 = time.perf_counter()
    save_model(args.output, info, params)
    dt = time.perf_counter() - t0
    size = Path(args.output).stat().st_size / 1e6
    print(f"wrote {args.output}: {size:.1f} MB in {dt:.1f}s")


if __name__ == "__main__":
    main()
