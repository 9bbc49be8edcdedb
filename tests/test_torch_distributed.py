"""The port's serving across ranks, ``Engine(mesh=, tp_mode=)`` and
``runtime.DistributedEngine``, against the JAX package's on the CPU, and
the launcher's deadline.

Two spawns of gloo ranks (``parallel/launch.py``: a ``file://``
rendezvous, a 60 s collective timeout, a 120 s deadline) run every case:
two ranks the meshes (1, 2) and (2, 1) and the DistributedEngines, four
the mesh (2, 2); the ranks write their results, and the tests here hold
them against the
JAX package's ``Engine(mesh=, tp_mode=)`` and ``DistributedEngine`` run
in this process on its (2, 2) CPU mesh (one JAX mesh for every port
mesh: the function does not depend on it). The ranks import no JAX.

Model: RWKV-7 at L = 4, C = 256, head size 16, f32 (the same bytes for
both packages); tolerance rtol = atol = 2e-4 on logits and states
(tests/test_sharding.py's). The lane states that ``back_state`` reads
and ``load_state`` writes back are compared bit for bit within the port.
"""

import time

import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import load_model
from web_rwkv_gguf_tpu_torch.parallel import make_mesh
from web_rwkv_gguf_tpu_torch.parallel.launch import LaunchError, launch
from web_rwkv_gguf_tpu_torch.runtime import (
    DistributedEngine, Engine, RnnInput, RnnInputBatch, RnnOption)

TOL = 2e-4
MESHES = [(1, 2), (2, 1), (2, 2)]
PLANS = ("gspmd", "shard_map")
MODEL = dict(n_layer=4, n_emb=256, head_size=16, n_vocab=64, n_hidden=512, seed=51)
PROMPTS = ([1, 2, 3, 4, 5], [9, 8, 7], [4, 4, 6, 1, 2, 3, 7, 8], [5])


def _model(path):
    return load_model(GgufFile(open(path, "rb").read()), dtype=torch.float32, device="cpu")


def engine_scenario(eng, RnnInput=RnnInput, RnnInputBatch=RnnInputBatch, RnnOption=RnnOption):
    """Four lanes, LAST and FULL, one prefill chunk and one decode step;
    then ``back_state`` of every lane, a reset and ``load_state`` of lane
    2, lane 0's state loaded into lane 3, and one more decode step.
    Returns ``(logit rows, states, round trip held)``. The scheduler
    classes are the engine's package's."""
    options = (RnnOption.FULL, RnnOption.LAST, RnnOption.LAST, RnnOption.FULL)
    inp = RnnInput([RnnInputBatch(list(p), o) for p, o in zip(PROMPTS, options)], 32)
    rows = []
    while inp.num_token:
        rows.extend(np.asarray(b) for b in eng.infer(inp).batches)
    step = [[11], [12], [13], [14]]

    def decode():
        inp = RnnInput([RnnInputBatch(list(t)) for t in step], 32)
        rows.extend(np.asarray(b) for b in eng.infer(inp).batches)

    decode()
    states = [eng.back_state(b) for b in range(4)]
    eng.reset_state(2)
    fresh = eng.back_state(2)
    eng.load_state(2, states[2])
    kept = all(np.array_equal(eng.back_state(2)[k], states[2][k]) for k in states[2])
    kept &= all(np.abs(fresh[k]).max() == 0 for k in fresh if k == "wkv")
    eng.load_state(3, states[0])
    decode()
    return rows, states, bool(kept)


def multihost_scenario(infer, reset_lane, emb_row, RnnInput=RnnInput,
                       RnnInputBatch=RnnInputBatch, RnnOption=RnnOption):
    """tests/test_multihost.py's scenario with fixed tokens: mixed
    LAST/FULL lanes, then a lane swap mid-stream (lane 1 reset and given a
    new prompt) while lane 0 goes on with one embedding-vector token
    (Token::Embed). Returns every logit row in order. The scheduler
    classes are the engine's package's."""
    inp = RnnInput([RnnInputBatch([1, 2, 3, 4, 5], RnnOption.LAST),
                    RnnInputBatch([9, 8, 7], RnnOption.FULL)], 32)
    rows = []
    while inp.num_token:
        rows.extend(np.asarray(r) for b in infer(inp).batches for r in b)
    reset_lane(1)
    inp.batches[0].tokens = [17, emb_row]
    inp.batches[1] = RnnInputBatch([4, 5, 6], RnnOption.FULL)
    while inp.num_token:
        rows.extend(np.asarray(r) for b in infer(inp).batches for r in b)
    return rows


def rank_main(rank, world, path, meshes, distributed):
    """A rank's cases: the mesh Engine on each of ``meshes`` over these
    ranks in both plans, then, with ``distributed``, three
    DistributedEngines in turn (:func:`distributed_cases`)."""
    info, params = _model(path)
    out = {}
    for shape in meshes:
        mesh = make_mesh(*shape, device="cpu")
        out[shape] = {plan: engine_scenario(Engine(info, params, 4, token_chunk_size=32,
                                                   mesh=mesh, tp_mode=plan, device="cpu"))
                      for plan in PLANS}
    if distributed:
        out["distributed"] = distributed_cases(info, params)
    return out


def distributed_cases(info, params):
    """Three DistributedEngines in turn over two ranks: replicas without a
    mesh, mesh (1, 2) under ``shard_map``, mesh (2, 1) under ``gspmd``.
    Rank 0 returns each one's logit rows, a worker nothing."""
    out = {}
    for key, mesh, plan in (("replicas", None, "gspmd"),
                            ("tp", make_mesh(1, 2, device="cpu"), "shard_map"),
                            ("dp", make_mesh(2, 1, device="cpu"), "gspmd")):
        eng = DistributedEngine(info, params, 2, mesh=mesh, token_chunk_size=32,
                                tp_mode=plan, device="cpu")
        if eng.is_coordinator:
            emb_row = params["emb"][11].float().numpy()
            out[key] = multihost_scenario(eng.infer, eng.reset_lane, emb_row)
            eng.shutdown()
        else:
            eng.serve()
    return out


def failing_rank(rank, world):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    path = tmp_path_factory.mktemp("dist") / "v7.gguf"
    path.write_bytes(bytes(make_v7_gguf(**MODEL)))
    return str(path)


@pytest.fixture(scope="module")
def jax_model(model_path):
    import jax.numpy as jnp

    from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
    from web_rwkv_gguf_tpu.models import load_model as jax_load_model

    return jax_load_model(JaxGgufFile(open(model_path, "rb").read()), dtype=jnp.float32)


def _jax_mesh():
    import jax

    from web_rwkv_gguf_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(2, 2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def jax_engine_runs(jax_model):
    """The JAX package's ``Engine(mesh=, tp_mode=)`` through the same
    scenario, per plan (gspmd given ``shard_params``'s placement, as the
    JAX engine expects)."""
    from web_rwkv_gguf_tpu.parallel import shard_params as jshard
    from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
    from web_rwkv_gguf_tpu.runtime import scheduler

    info, params = jax_model
    mesh = _jax_mesh()
    out = {}
    for plan in PLANS:
        p = jshard(params, mesh, info) if plan == "gspmd" else params
        eng = JaxEngine(info, p, num_batch=4, token_chunk_size=32, mesh=mesh, tp_mode=plan)
        out[plan] = engine_scenario(eng, scheduler.RnnInput, scheduler.RnnInputBatch,
                                    scheduler.RnnOption)
    return out


@pytest.fixture(scope="module")
def spawned(model_path):
    """Each world size's ranks, launched once (filled on first use): two
    ranks run the meshes (1, 2) and (2, 1) and the DistributedEngines,
    four the mesh (2, 2)."""
    cache = {}

    def results(world):
        if world not in cache:
            meshes = [m for m in MESHES if m[0] * m[1] == world]
            cache[world] = launch(f"{__name__}:rank_main", world,
                                  args=(model_path, meshes, world == 2), deadline=120,
                                  timeout=60)
        return cache[world]

    return results


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"mesh{m[0]}x{m[1]}")
def engine_results(request, spawned):
    return [res[request.param] for res in spawned(request.param[0] * request.param[1])]


@pytest.mark.parametrize("plan", PLANS)
def test_engine_mesh_matches_jax(engine_results, jax_engine_runs, plan):
    """``Engine(mesh=, tp_mode=)``: every rank's whole ``RnnOutput`` (LAST
    and FULL lanes, prefill and decode) and every lane's ``back_state``
    against the JAX package's mesh Engine (largest seen: 4e-6 logits);
    a lane reset reads zeros and ``load_state`` gives back the lane bit
    for bit; lane 0's state loaded into lane 3 (another data rank on
    (2, *)) decodes as the JAX engine's does."""
    rows_w, states_w, _ = jax_engine_runs[plan]
    for res in engine_results:
        rows, states, kept = res[plan]
        assert kept
        assert [r.shape for r in rows] == [r.shape for r in rows_w]
        for got, want in zip(rows, rows_w):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for got, want in zip(states, states_w):
            for k in want:
                w = np.asarray(want[k])
                np.testing.assert_allclose(got[k], w, rtol=TOL,
                                           atol=TOL * max(1.0, np.abs(w).max()), err_msg=k)


@pytest.fixture(scope="module")
def distributed_results(spawned):
    return [res["distributed"] for res in spawned(2)]


@pytest.fixture(scope="module")
def jax_distributed_rows(jax_model):
    """The JAX package's ``DistributedEngine`` in one process, on its (2, 2)
    mesh under ``shard_map`` (tests/test_distributed.py's form)."""
    from web_rwkv_gguf_tpu.parallel.tensor import shard_params_tp as jshard_tp
    from web_rwkv_gguf_tpu.runtime import DistributedEngine as JaxDistributedEngine
    from web_rwkv_gguf_tpu.runtime import scheduler

    info, params = jax_model
    mesh = _jax_mesh()
    eng = JaxDistributedEngine(info, jshard_tp(params, mesh, info), num_batch=2, mesh=mesh,
                               token_chunk_size=32, tp_mode="shard_map")
    emb_row = np.asarray(params["emb"], np.float32)[11]
    return multihost_scenario(eng.infer, eng.reset_lane, emb_row, scheduler.RnnInput,
                              scheduler.RnnInputBatch, scheduler.RnnOption)


@pytest.mark.parametrize("case", ["replicas", "tp", "dp"])
def test_distributed_engine_matches_jax(distributed_results, jax_distributed_rows, case):
    """The coordinator's logit rows through the multihost scenario, with
    the workers in ``serve()`` until ``shutdown()``: replicas, tensor
    parallel and data parallel over two ranks, each against the JAX
    package's DistributedEngine (largest seen: 4e-6)."""
    rows = distributed_results[0][case]
    assert len(rows) == len(jax_distributed_rows)
    for got, want in zip(rows, jax_distributed_rows):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert distributed_results[1] == {}  # a worker returns nothing


def test_distributed_engine_single_process(model_path):
    """Without a process group the broadcast is the identity: one
    coordinator alone gives the meshless Engine's rows (the same function;
    its head runs on another row count for the LAST-only chunks, so to
    1e-6)."""
    info, params = _model(model_path)
    eng = DistributedEngine(info, params, 2, token_chunk_size=32, device="cpu")
    ref = Engine(info, params, 2, token_chunk_size=32, unroll=False, device="cpu")
    emb_row = params["emb"][11].float().numpy()
    got = multihost_scenario(eng.infer, eng.reset_lane, emb_row)
    want = multihost_scenario(ref.infer, ref.reset_state, emb_row)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    with pytest.raises(Exception, match="requires a mesh"):
        DistributedEngine(info, params, 2, tp_mode="shard_map", device="cpu")


def test_a_failing_rank_fails_the_launch_within_its_deadline():
    """A rank that raises ends the launch at once, with its traceback,
    while the other still waits in a collective (killed, not joined)."""
    t0 = time.monotonic()
    with pytest.raises(LaunchError, match="rank 1 fails on purpose"):
        launch(f"{__name__}:failing_rank", 2, deadline=60, timeout=30)
    assert time.monotonic() - t0 < 30


def test_engine_mesh_options():
    """What the mesh Engine refuses: an unknown ``tp_mode``; the
    sequence-parallel and pipeline options without a mesh (the JAX
    Engine's EngineError), and a pipeline whose lanes do not divide by its
    microbatches. On a mesh both options build."""
    from web_rwkv_gguf_tpu_torch.errors import EngineError
    from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

    info, params = load_model(GgufFile(make_v7_gguf()), device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    with pytest.raises(EngineError, match="tp_mode"):
        Engine(info, params, 2, mesh=mesh, tp_mode="pjit", device="cpu")
    with pytest.raises(EngineError, match="requires a mesh"):
        Engine(info, params, 2, seq_parallel=True, device="cpu")
    with pytest.raises(EngineError, match="requires a mesh"):
        Engine(info, params, 2, pipeline_microbatches=2, device="cpu")
    with pytest.raises(EngineError, match="divide"):
        Engine(info, params, 3, mesh=mesh, pipeline_microbatches=2, device="cpu")
    assert Engine(info, params, 2, mesh=mesh, seq_parallel=True).plan == "sequence"
    assert Engine(info, params, 2, mesh=mesh, pipeline_microbatches=2).plan == "pipeline"
