"""Start the ranks of one host, join them against a deadline, collect what
they return.

``launch("pkg.module:function", world_size, args=...)`` starts
``world_size`` processes with the ``spawn`` start method (CUDA cannot
cross a fork). Each joins a process group through a ``file://``
rendezvous in a fresh directory (no TCP port is bound in advance), with
the collective ``timeout`` given, runs ``function(rank, world_size,
*args)``, and writes its result (``torch.save``) or its traceback to
that directory; its standard output and error go to files there too
(a directory made by the launcher is removed when it returns).
The parent waits until every rank has finished, one has failed, or the
``deadline`` has passed; then it kills what still runs and raises
:class:`LaunchError` with each rank's error tail, or returns the ranks'
results in rank order.

Run a mesh of two CPU ranks::

    from web_rwkv_gguf_tpu_torch.parallel.launch import launch
    results = launch("mymodule:rank_main", 2, args=(path,), backend="gloo")

where ``mymodule.rank_main(rank, world_size, path)`` builds
``parallel.make_mesh(...)`` and the engine from the same arguments on
every rank. Ranks that share one card take ``backend="gloo"``; ranks on
distinct cards ``"nccl"``.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback

import torch


class LaunchError(RuntimeError):
    """A rank failed, or the ranks did not finish within the deadline."""


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def _rank_main(target: str, rank: int, world_size: int, args: tuple, workdir: str,
               backend: str, timeout: float, threads: int | None):
    """A rank's process: its output to files, the process group joined,
    the target run, its result or traceback written."""
    for fd, name in ((1, "out"), (2, "err")):
        f = os.open(os.path.join(workdir, f"rank{rank}.{name}"),
                    os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        os.dup2(f, fd)
    if threads:
        torch.set_num_threads(threads)
    from .sharding import multihost_initialize

    import torch.distributed as dist

    try:
        multihost_initialize(backend=backend, rank=rank, world_size=world_size,
                             init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                             timeout=timeout)
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(rank, world_size, *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.fail"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(target: str, world_size: int, *, args: tuple = (), backend: str = "gloo",
           deadline: float = 120.0, timeout: float = 60.0, workdir: str | None = None,
           threads: int | None = 1) -> list:
    """Run ``target`` (``"module:function"``) on ``world_size`` spawned
    ranks (see the module docstring) and return their results in rank
    order. ``timeout``: each collective's limit, seconds; ``deadline``:
    the whole launch's; ``threads``: each rank's CPU threads (None: the
    default). Raises :class:`LaunchError` with every rank's error tail when
    a rank fails or the deadline passes; no rank outlives the call. A
    ``workdir`` given is kept; one made here is removed."""
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="launch-")
        try:
            return launch(target, world_size, args=args, backend=backend, deadline=deadline,
                          timeout=timeout, workdir=workdir, threads=threads)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, world_size, args, workdir, backend, timeout, threads))
             for r in range(world_size)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    failed = timed_out = False
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                failed = True
                break
            if time.monotonic() > end:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    codes = [p.exitcode for p in procs]
    if failed or timed_out or any(c != 0 for c in codes):
        why = (f"the ranks did not finish within {deadline} s" if timed_out
               else f"a rank failed (exit codes {codes})")
        tails = "\n".join(
            f"--- rank {r} ---\n{_tail(os.path.join(workdir, f'rank{r}.fail'))}"
            f"{_tail(os.path.join(workdir, f'rank{r}.err'))}" for r in range(world_size))
        raise LaunchError(f"{target}: {why}\n{tails}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size)]
