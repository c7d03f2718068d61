"""``ray_tpu_torch.serve.llm.build_llm_deployment`` on the port's local
runtime against ``ray_tpu``'s deployment on its own, on the CPU.

Both serve ``tiny_config`` Llama on the same weights (``ray_tpu``'s
``llama.init_params``, carried across by ``from_jax_params``) through
``serve.run(build_llm_deployment(...))`` and ``handle.remote``: greedy
tokens identical, streaming and not. Then the port's deployment on its
own: two replicas with prefix affinity (``cached_prefix_len``), the
replica load snapshot's keys against ``ray_tpu``'s, the params tree
passed by reference down to each replica's engine, ``disaggregated=True``
building ``ray_tpu``'s two pools, ``use_gpu`` without a card failing at the
replica's constructor, and no engine thread left after
``serve.shutdown()``.
"""

import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.serve as jserve
import ray_tpu_torch
from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import build_llm_deployment as jbuild
from ray_tpu_torch import serve
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.llm import LLMServer, build_llm_deployment

BASE = dict(max_batch=2, max_len=128, prompt_buckets=[16, 32, 64],
            decode_chunk=4, prefix_block=16, seed=0)
NEW = 6
_rng = np.random.RandomState(3)
PROMPTS = [_rng.randint(1, 256, n).tolist() for n in (5, 17, 33, 9, 40)]
PREFIX = _rng.randint(1, 256, 48).tolist()  # three 16-token blocks
SHARED = [PREFIX + [200 + i, 7] for i in range(4)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    tcfg = tllama.tiny_config(max_seq_len=128)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


def _replica_instances(runtime):
    """The live ReplicaActor objects of a LocalRuntime."""
    return [s.instance for s in runtime._actors.values()
            if not s.dead and hasattr(s.instance, "_callable")]


@pytest.fixture(scope="module")
def jax_served(weights):
    """ray_tpu's deployment on its own LocalRuntime: the prompts' tokens
    (non-streaming) and one streamed reply, and a replica's snapshot."""
    jcfg, jparams = weights[0], weights[1]
    rt = ray_tpu.init(local_mode=True)
    try:
        h = jserve.run(jbuild(name="jllm",
                              engine_kwargs=dict(cfg=jcfg, params=jparams,
                                                 **BASE)))
        toks = [h.remote({"prompt_ids": p, "max_new_tokens": NEW})
                .result(timeout=120)["token_ids"] for p in PROMPTS]
        streamed = list(h.options("stream", stream=True).remote(
            {"prompt_ids": PROMPTS[2], "max_new_tokens": NEW}))
        snap = _replica_instances(rt)[0].load_snapshot()
    finally:
        # ray_tpu's replicas never close their engines: stop the threads
        # here, then the runtime.
        for inst in _replica_instances(rt):
            inst._callable.engine.close()
        jserve.shutdown()
        ray_tpu.shutdown()
    return {"tokens": toks, "streamed": streamed, "snapshot": snap}


@pytest.fixture
def runtime():
    rt = ray_tpu_torch.init(local_mode=True)
    try:
        yield rt
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def _deploy(weights, **kw):
    tcfg, tparams = weights[2], weights[3]
    return serve.run(build_llm_deployment(
        engine_kwargs=dict(cfg=tcfg, params=tparams, device="cpu", **BASE),
        **kw))


def test_tokens_match_ray_tpu_deployment(weights, jax_served, runtime):
    h = _deploy(weights)
    got = [h.remote({"prompt_ids": p, "max_new_tokens": NEW})
           .result(timeout=60) for p in PROMPTS]
    assert [g["token_ids"] for g in got] == jax_served["tokens"]
    assert all(g["num_generated"] == NEW for g in got)


def test_streaming_matches_ray_tpu_and_the_reply(weights, jax_served,
                                                 runtime):
    h = _deploy(weights)
    streamed = list(h.options("stream", stream=True).remote(
        {"prompt_ids": PROMPTS[2], "max_new_tokens": NEW}))
    assert streamed == jax_served["streamed"] == jax_served["tokens"][2]
    reply = h.remote({"prompt_ids": PROMPTS[2], "max_new_tokens": NEW}
                     ).result(timeout=60)
    assert reply["token_ids"] == streamed


def _wait_resident(router, chain, timeout=30.0):
    """Until some replica's pushed snapshot holds the whole chain (the
    controller sweeps once per reconcile period)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        with router._lock:
            fresh = router._fresh_loads()
            if fresh and any(set(chain) <= s.get("prefix_hashes", set())
                             for s in fresh.values()):
                return
        time.sleep(0.05)
    raise AssertionError("no replica reported the prefix resident")


def test_two_replicas_route_shared_prefixes_to_their_cache(weights,
                                                           runtime):
    from ray_tpu_torch.serve.engine.kv_manager import chain_hashes

    h = _deploy(weights, num_replicas=2)
    chain = chain_hashes(PREFIX, BASE["prefix_block"])
    cached = []
    for i, p in enumerate(SHARED):
        out = h.remote({"prompt_ids": p, "max_new_tokens": NEW}
                       ).result(timeout=60)
        cached.append(out["cached_prefix_len"])
        if i == 0:
            _wait_resident(h._router, chain)
    assert cached[0] == 0
    assert all(c >= len(PREFIX) for c in cached[1:]), cached
    assert h._router.stats()["affinity_routes"] >= len(SHARED) - 1
    replicas = _replica_instances(runtime)
    assert len(replicas) == 2
    served = sorted(r._callable.stats()["requests"] for r in replicas)
    assert served == [0, len(SHARED)]


def test_load_snapshot_keys_match_ray_tpu(weights, jax_served, runtime):
    h = _deploy(weights)
    h.remote({"prompt_ids": PROMPTS[0], "max_new_tokens": 2}
             ).result(timeout=60)
    snap = _replica_instances(runtime)[0].load_snapshot()
    assert set(snap) == set(jax_served["snapshot"])


def test_params_reach_each_replica_by_reference(weights, runtime):
    tparams = weights[3]
    _deploy(weights, num_replicas=2)
    replicas = _replica_instances(runtime)
    assert len(replicas) == 2
    for r in replicas:
        eng = r._callable.engine
        assert eng.params is tparams
        assert eng.params["embed"] is tparams["embed"]
        for name, leaf in tparams["blocks"].items():
            assert eng.params["blocks"][name] is leaf


def test_disaggregated_raises():
    """``disaggregated=True`` builds ``ray_tpu``'s two pools: the prefill
    pool, bound to the decode pool, each asking one ``GPU`` a replica with
    ``use_gpu`` where ``ray_tpu``'s asks one ``TPU`` with ``use_tpu``."""
    from ray_tpu_torch.serve.llm import DecodeLLMServer, PrefillLLMServer

    ek = dict(max_batch=2, seed=0)
    dep = build_llm_deployment("pd", use_gpu=True, disaggregated=True,
                               num_prefill_replicas=2,
                               num_decode_replicas=3, engine_kwargs=ek)
    jdep = jbuild("pd", use_tpu=True, disaggregated=True,
                  num_prefill_replicas=2, num_decode_replicas=3,
                  engine_kwargs=ek)
    (decode,), (jdecode,) = dep._init_args, jdep._init_args
    assert dep._cls is PrefillLLMServer and decode._cls is DecodeLLMServer
    assert dep._init_kwargs == decode._init_kwargs == ek
    for got, want in ((dep, jdep), (decode, jdecode)):
        assert got.name == want.name
        opts = dict(got._config)
        assert opts.pop("ray_actor_options") == {"resources": {"GPU": 1.0}}
        jopts = dict(want._config)
        assert jopts.pop("ray_actor_options") == {"resources": {"TPU": 1.0}}
        assert opts == jopts
    assert (dep.name, decode.name) == ("pd", "pd-decode")
    assert (dep._config["num_replicas"], decode._config["num_replicas"]) \
        == (2, 3)


def test_use_gpu_without_a_card_fails_at_the_replica(weights, runtime):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the replica builds there")
    tcfg, tparams = weights[2], weights[3]
    with pytest.raises(ray_tpu_torch.exceptions.ActorDiedError,
                       match="no CUDA device"):
        serve.run(build_llm_deployment(
            use_gpu=True, engine_kwargs=dict(cfg=tcfg, params=tparams,
                                             **BASE)))


def test_use_gpu_asks_for_a_gpu():
    dep = build_llm_deployment(use_gpu=True, num_replicas=3)
    assert dep._config["ray_actor_options"] == {"resources": {"GPU": 1.0}}
    assert dep._config["num_replicas"] == 3
    assert dep._cls is LLMServer


def test_shutdown_closes_every_engine(weights, runtime):
    h = _deploy(weights, num_replicas=2)
    h.remote({"prompt_ids": PROMPTS[1], "max_new_tokens": 2}
             ).result(timeout=60)
    engines = [r._callable.engine for r in _replica_instances(runtime)]
    assert len(engines) == 2 and all(e._thread.is_alive() for e in engines)
    serve.shutdown()
    assert not any(e._thread.is_alive() for e in engines)
