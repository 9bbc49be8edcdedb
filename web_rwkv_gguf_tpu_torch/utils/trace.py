"""Tracing and profiling helpers on ``torch.profiler`` (the reference's
``trace`` feature with Tracy, ref: Cargo.toml:53-55, context.rs:155-157);
the traces are Chrome trace JSON, which Perfetto opens.

Usage:
    with trace_to("/tmp/rwkv-trace"):
        engine.infer(input)

or annotate custom regions:
    with span("prefill"):
        ...
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the host and, where there is a card, its kernels, and write
    the trace as ``logdir/trace_<pid>_<n>.json``. The profiler is yielded:
    its ``key_averages()`` and ``events()`` hold what it saw."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = sum(1 for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_"))
    path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    log.info("profile written to %s", path)


@contextlib.contextmanager
def span(name: str):
    """Named host span: a ``record_function`` range in profiles (and an
    NVTX range where there is a card), timed in the debug log."""
    t0 = time.perf_counter()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    log.debug("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)


def annotate(name: str):
    """Decorator version of :func:`span`."""

    def deco(fn):
        def wrapped(*a, **kw):
            with span(name):
                return fn(*a, **kw)

        return wrapped

    return deco


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for item in items:
        leaf = _first_tensor(item)
        if leaf is not None:
            return leaf
    return None


def device_sync(tree):
    """Wait until the work behind ``tree`` (a tensor, or dicts, lists and
    tuples of them) has run: synchronise the device of its first tensor,
    then fetch one element of it to the host (on the CPU only the fetch).
    Returns that element as numpy (a bf16 one as f32, which numpy lacks),
    or ``tree`` where it holds no tensor."""
    leaf = _first_tensor(tree)
    if leaf is None:
        return tree
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    first = leaf.reshape(-1)[:1].cpu()
    return (first.float() if first.dtype == torch.bfloat16 else first).numpy()
