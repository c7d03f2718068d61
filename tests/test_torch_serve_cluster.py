"""``build_llm_deployment`` on the port's cluster runtime, on the CPU.

The controller and every replica are actors in worker processes; the
handle, its replies and its streams cross processes. ``tiny_config``
Llama on ``ray_tpu``'s weights (``llama.init_params``, carried across by
``from_jax_params``; the tree travels to each replica through the
object store's tensor path) serves the same prompts as ``ray_tpu``'s
JAX ``LLMEngine``: greedy tokens identical with one replica, with two,
and streamed.
"""

import threading

import jax
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu_torch import serve
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.llm import build_llm_deployment

BASE = dict(max_batch=2, max_len=128, prompt_buckets=[16, 32, 64],
            decode_chunk=4, prefix_block=16, seed=0)
NEW = 6
_rng = np.random.RandomState(3)
PROMPTS = [_rng.randint(1, 256, n).tolist() for n in (5, 17, 33, 9, 40, 12)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    tcfg = tllama.tiny_config(max_seq_len=128)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """``ray_tpu``'s JAX engine on the same weights, one prompt at a
    time: the greedy tokens every deployment below is held to."""
    jcfg, jparams = weights[0], weights[1]
    eng = JEngine(cfg=jcfg, params=jparams, **BASE)
    try:
        return [eng.generate(p, max_new_tokens=NEW)["token_ids"]
                for p in PROMPTS]
    finally:
        eng.close()


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
            for p in rt._procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)


def _deploy(weights, name, n):
    tcfg, tparams = weights[2], weights[3]
    return serve.run(build_llm_deployment(
        name, num_replicas=n,
        engine_kwargs=dict(cfg=tcfg, params=tparams, device="cpu", **BASE)))


def _replica_stats(name):
    controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
    replicas = ray_tpu_torch.get(controller.get_replicas.remote(name),
                                 timeout=60)
    return ray_tpu_torch.get(
        [r.handle_request.remote("stats", (), {}) for r in replicas],
        timeout=60)


def _engine_threads_here():
    return [t for t in threading.enumerate() if t.name == "llm-engine"]


def test_one_replica_in_a_worker_process(cluster, weights, jax_tokens):
    h = _deploy(weights, "llm_one", 1)
    try:
        got = [h.remote({"prompt_ids": p, "max_new_tokens": NEW})
               .result(timeout=120)["token_ids"] for p in PROMPTS]
        assert got == jax_tokens
        # The engine runs in the replica's process, not in this one.
        assert _engine_threads_here() == []
        (stats,) = _replica_stats("llm_one")
        assert stats["requests"] == len(PROMPTS)
    finally:
        serve.delete("llm_one")


def test_two_replicas(cluster, weights, jax_tokens):
    h = _deploy(weights, "llm_two", 2)
    try:
        resps = [h.remote({"prompt_ids": p, "max_new_tokens": NEW})
                 for p in PROMPTS * 2]
        got = [r.result(timeout=120)["token_ids"] for r in resps]
        assert got == jax_tokens * 2
        served = [s["requests"] for s in _replica_stats("llm_two")]
        assert len(served) == 2 and sum(served) == 2 * len(PROMPTS)
        assert min(served) >= 1  # both worker processes served tokens
    finally:
        serve.delete("llm_two")


def test_stream_crosses_processes(cluster, weights, jax_tokens):
    h = _deploy(weights, "llm_stream", 1)
    try:
        for p, want in zip(PROMPTS[:3], jax_tokens[:3]):
            streamed = list(h.options("stream", stream=True).remote(
                {"prompt_ids": p, "max_new_tokens": NEW}))
            assert streamed == want
    finally:
        serve.delete("llm_stream")


def test_shutdown_removes_the_controller(cluster, weights):
    h = _deploy(weights, "llm_gone", 1)
    assert len(h.remote({"prompt_ids": PROMPTS[0], "max_new_tokens": 2})
               .result(timeout=120)["token_ids"]) == 2
    serve.shutdown()
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("rtpu-serve-controller")
