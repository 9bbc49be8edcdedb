"""The compiled step: the serving step captured as CUDA graphs.

The port's counterpart of the JAX package's ``jax.jit(...,
donate_argnums=(1,))``: the JAX Engine jits its forward, its embedding
forward, its all-LAST forward with the head and ``make_generator``'s
decode segment, one program per (B, T bucket), its hooks traced into
each, and donates the state (engine.py:1-9, 299-329, 729-735 and
models/generate.py:81-132 of the JAX package). Here each such step is
captured once into a CUDA graph and replayed, the state updated in
place.

A :class:`StepGraphs` holds what one engine's graphs share: the recurrent
state as static buffers that every replay reads and writes in place, one
memory pool (several engines may share one), the stream the graphs are
captured on, and the graphs by key. :meth:`StepGraphs.run` runs a step
given as ``make(static_inputs, state) -> fn``, ``fn`` a closure that
reads only the static buffers, writes the new state into ``state``
(:func:`commit`) and returns its other outputs:

- the first call of a key (or of a key whose params object changed)
  copies the inputs into new static buffers, runs ``fn`` once eagerly on
  the capture stream (the warm-up: it builds the kernel libraries, sets
  their attributes, probes cluster residency and makes the whole-stack
  kernels' split-K counters, none of which may happen under capture),
  captures ``fn`` through :data:`CAPTURE`, then puts the state, the
  sampling generators and the launch counts back as they were before the
  warm-up;
- every call, the first included, copies each state tensor that is not
  its static buffer into it (after ``Engine.reset_state()``, a caller's
  assignment, a pool's hand-over), copies the inputs into the key's
  static buffers and replays; the outputs are handed out as copies, since
  the next replay of any graph in the pool may overwrite them.

Launch counts: each kernel wrapper counts its launches and shapes on the
host, which runs at capture and never at a replay. A graph keeps the
counts its capture added and adds them at each replay, so a replayed
step reports what the eager step reports.

Hooks: a step's hooks (``models.forward.HookCtx``) are Python calls
inside ``fn``, so they run at the warm-up and at the capture, and only
the device work they added replays: the JAX contract, where a hook is
traced once. A hook that reads the host (``.item()``, ``.cpu()``,
``bool(tensor)``, ``torch.tensor(list, device="cuda")``) cannot be
captured: the capture's error is raised again as ``UnsupportedFeature``
naming ``graph=False``, with the state, the generators and the counts
put back as they were before the step; nothing falls back to the eager
step.

What runs eagerly instead is the caller's explicit rule (``Engine``,
``make_generator``): the mesh plans and a ``make_generator(step=)``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time
from dataclasses import dataclass

import torch

from ..errors import UnsupportedFeature
from ..ops.cuda import layer7, layer56, matmul, wkv4, wkv6, wkv7

# every kernel wrapper that counts its launches (``.launches``, ``.shapes``)
COUNTED = {
    **{name: getattr(matmul, name) for name in (
        "q4k_gemv", "q4k_gemm", "q6k_gemv", "q6k_gemm", "qkb_gemv", "qkb_gemm", "qs_gemv",
        "qs_gemm", "nf4_gemv", "nf4_gemm", "quant_gemv_grouped")},
    "att_core7_step": wkv7.att_core7_step, "wkv7_scan": wkv7.wkv7_scan,
    "layer_scan7": layer7.layer_scan7, "wkv6_scan": wkv6.wkv6_scan,
    "layer_scan56": layer56.layer_scan56, "wkv4_scan": wkv4.wkv4_scan,
}


def launch_counts() -> dict:
    """Every counted wrapper's ``(launches, Counter of launches by shape)``."""
    return {name: (fn.launches, collections.Counter(fn.shapes)) for name, fn in COUNTED.items()}


def set_launch_counts(counts: dict):
    """Put the counts of :func:`launch_counts` back (shapes in place)."""
    for name, (n, shapes) in counts.items():
        fn = COUNTED[name]
        fn.launches = n
        fn.shapes.clear()
        fn.shapes.update(shapes)


def count_delta(before: dict, after: dict) -> dict:
    """The counts added between two :func:`launch_counts`, kernels that
    launched only."""
    return {name: (after[name][0] - n, after[name][1] - shapes)
            for name, (n, shapes) in before.items() if after[name][0] != n}


def add_launch_counts(delta: dict):
    """Add a :func:`count_delta` to the wrappers' counts."""
    for name, (n, shapes) in delta.items():
        fn = COUNTED[name]
        fn.launches += n
        fn.shapes.update(shapes)


def capture_cuda(fn, pool, stream, generators):
    """Capture ``fn`` into a CUDA graph in ``pool`` on ``stream``, the
    sampling ``generators`` registered so that each replay draws new
    numbers and advances them. Returns ``replay() -> fn's outputs`` (the
    graph's own output tensors, rewritten by every replay)."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    # the cyclic collector stays off while the stream captures: a dead
    # engine's graphs, collected there, would be destroyed on a capturing
    # stream, and that invalidates the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        # torch.cuda.graph's steps, by hand: where fn fails (a host read under
        # capture), the capture is ended and the stream put back all the same
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                out = fn()
            except BaseException:
                _end_failed_capture(graph, stream.device, pool)
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()

    def replay():
        graph.replay()
        return out

    return replay


def _end_failed_capture(graph, device, pool):
    """End a capture that its step made invalid: ``cudaStreamEndCapture``
    ends it and reports the fault, and PyTorch raises that before it stops
    routing the capture stream's allocations to ``pool``, which is stopped
    here. The step's own error is the one the caller raises."""
    with contextlib.suppress(RuntimeError):
        graph.capture_end()
    with contextlib.suppress(RuntimeError):  # a PyTorch that stopped it itself
        torch._C._cuda_endAllocateToPool(torch.device(device).index, pool)


# The capture factory ``(fn, pool, stream, generators) -> replay``. Tests
# replace it with a recorder that calls ``fn`` once at capture and again at
# each replay.
CAPTURE = capture_cuda


def new_pool(device):
    """A memory pool for graphs on ``device`` (``torch.cuda.
    graph_pool_handle()``; on the CPU a token that only a replacement of
    :data:`CAPTURE` reads)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.graph_pool_handle()
    return object()


def commit(state: dict, new: dict):
    """Write the step's ``new`` state into the static ``state`` in place
    (the donation of the JAX package's jitted step)."""
    for key, a in state.items():
        a.copy_(new[key])


@dataclass
class _Graph:
    params: object  # the params object the graph was captured on
    inputs: dict  # its static input buffers
    replay: object
    counts: dict  # the launch counts its capture added


class StepGraphs:
    """One engine's CUDA graphs, their static state, pool and stream (see
    the module docstring). ``state`` gives the static buffers' shapes and
    first contents (copied); ``pool`` is shared where given (an
    ``EnginePool``'s engines share one)."""

    def __init__(self, state: dict, pool=None):
        self.device = next(iter(state.values())).device
        self.state = {k: a.clone(memory_format=torch.contiguous_format)
                      for k, a in state.items()}
        self.pool = new_pool(self.device) if pool is None else pool
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.graphs: dict = {}
        self.capture_seconds = 0.0  # wall seconds of every warm-up and capture

    def drop(self):
        """Forget every graph (their params changed); the state stays."""
        self.graphs.clear()

    def adopt(self, state: dict) -> dict:
        """Copy each tensor of ``state`` that is not its static buffer into
        it; a new dict of the static buffers."""
        for key, a in self.state.items():
            b = state[key]
            if b is not a:
                if b.shape != a.shape:
                    raise ValueError(f"state {key} must be {tuple(a.shape)}, got "
                                     f"{tuple(b.shape)}")
                a.copy_(b)
        return dict(self.state)

    def run(self, key, params, make, inputs: dict, state: dict, generators=()):
        """The step ``key`` on ``params`` from ``state``, replayed (captured
        first where it has no graph on this params object): ``(copies of
        fn's outputs, the new state)``, the state a dict of the static
        buffers. ``inputs`` are tensors on any device; ``generators`` the
        ``torch.Generator``\\ s ``fn`` samples from."""
        self.adopt(state)
        graph = self.graphs.get(key)
        if graph is None or graph.params is not params:
            graph = self.graphs[key] = self._capture(key, params, make, inputs, generators)
        for name, t in inputs.items():
            graph.inputs[name].copy_(t)
        out = graph.replay()
        add_launch_counts(graph.counts)
        return tuple(o.clone() for o in out), dict(self.state)

    def _capture(self, key, params, make, inputs, generators) -> _Graph:
        t0 = time.perf_counter()
        static = {name: torch.empty(t.shape, dtype=t.dtype, device=self.device).copy_(t)
                  for name, t in inputs.items()}
        fn = make(static, self.state)
        saved = {k: a.clone() for k, a in self.state.items()}
        rng = [g.get_state() for g in generators]
        counts = launch_counts()
        try:
            if self.stream is not None:
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self.stream):
                    fn()
            else:
                fn()
            warm = launch_counts()
            try:
                replay = CAPTURE(fn, self.pool, self.stream, generators)
            except RuntimeError as e:
                raise UnsupportedFeature(
                    f"the step {key} cannot be captured as a CUDA graph ({e}); a step whose "
                    f"hooks read the host (.item(), .cpu(), bool(tensor), torch.tensor(list, "
                    f"device=...)) runs with graph=False") from e
            captured = count_delta(warm, launch_counts())
        finally:
            # the warm-up's and the capture's state, draws and counts go back
            set_launch_counts(counts)
            if self.stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(self.stream)
            commit(self.state, saved)
            for g, st in zip(generators, rng):
                g.set_state(st)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.capture_seconds += time.perf_counter() - t0
        return _Graph(params, static, replay, captured)
