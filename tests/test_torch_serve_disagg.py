"""``build_llm_deployment(disaggregated=True)`` on the port's cluster
runtime, on the CPU: the counterparts of ``tests/test_disagg_serve.py``'s
serve tier (``test_serve_disagg_stream_token_identity``,
``::test_serve_disagg_stream_reroute_on_decode_death`` and
``::test_serve_disagg_equivalence_and_reroute_on_death``).

One prefill replica and two decode replicas in worker processes, joined by
shm ring channels, serve ``tiny_config`` Llama on ``ray_tpu``'s weights
(``llama.init_params``, carried across by ``from_jax_params``). Every
reply and stream is held to ``ray_tpu``'s JAX ``LLMEngine`` on the same
weights and prompts: greedy tokens identical, a mid-stream EOS included,
after a decode replica is killed three tokens into a stream, and after one
of the two decode replicas dies. A budget-1 request finishes on the
prefill side. Every wait has its own bound, and the fixture shuts serve
and the cluster down in a ``finally``.
"""

import time

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
NEW = 12
PROMPTS = [
    [5, 9, 2, 7, 7, 1],
    [3, 3, 3, 3, 1, 2, 8, 4, 4, 4, 9, 9, 1, 0, 2, 5, 6, 7],
    list(range(1, 33)),  # multi-page prompt (block 16 -> 2 pages)
]
T = 120  # seconds: the bound of every reply


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11))
    tcfg = tllama.tiny_config(max_seq_len=128)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def jax_ref(weights):
    """``ray_tpu``'s colocated JAX engine: greedy tokens by (prompt,
    budget, eos)."""
    eng = JEngine(cfg=weights[0], params=weights[1], **BASE)
    memo = {}

    def ref(prompt, n=NEW, eos=None):
        key = (tuple(prompt), n, eos)
        if key not in memo:
            memo[key] = eng.generate(prompt, max_new_tokens=n,
                                     eos_id=eos)["token_ids"]
        return memo[key]

    try:
        yield ref
    finally:
        eng.close()


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=8, object_store_memory=128 << 20)
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


def _deploy(weights, name):
    tcfg, tparams = weights[2], weights[3]
    return serve.run(build_llm_deployment(
        name, disaggregated=True, num_decode_replicas=2,
        engine_kwargs=dict(cfg=tcfg, params=tparams, device="cpu", **BASE)))


def _delete(name):
    """Both pools: ``serve.delete`` removes one deployment."""
    serve.delete(name)
    serve.delete(f"{name}-decode")


def _decode_replicas(name):
    controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
    return ray_tpu_torch.get(
        controller.get_replicas.remote(f"{name}-decode"), timeout=30)


def _collect_stream(handle, payload, timeout=240.0):
    deadline = time.time() + timeout
    toks = []
    for t in handle.options("stream", stream=True).remote(payload):
        toks.append(int(t))
        assert time.time() < deadline, "stream stalled"
    return toks


def test_serve_disagg_stream_token_identity(cluster, weights, jax_ref):
    """Replies and streams (the prefill-time first token, then decode
    deltas over the reverse result channel) equal ``ray_tpu``'s tokens,
    the multi-page prompt and a mid-stream EOS stop included."""
    h = _deploy(weights, "stdis")
    try:
        for p in PROMPTS:
            req = {"prompt_ids": p, "max_new_tokens": NEW}
            ref = jax_ref(p)
            assert h.remote(dict(req)).result(timeout=T)["token_ids"] == ref
            assert _collect_stream(h, dict(req)) == ref, p
        # Mid-stream EOS: a token the reference emits mid-generation made
        # the stop token; both paths truncate there, EOS included.
        p = PROMPTS[2]
        eos = jax_ref(p)[4]
        want = jax_ref(p, eos=eos)
        assert want[-1] == eos and len(want) < NEW
        req = {"prompt_ids": p, "max_new_tokens": NEW, "eos_id": eos}
        assert h.remote(dict(req)).result(timeout=T)["token_ids"] == want
        assert _collect_stream(h, dict(req)) == want
    finally:
        _delete("stdis")


def test_serve_disagg_budget_one_finishes_on_prefill(cluster, weights,
                                                     jax_ref):
    """A request that finishes at its first token never reaches a decode
    replica: no decode replica counts a request."""
    h = _deploy(weights, "b1dis")
    try:
        for p in PROMPTS:
            req = {"prompt_ids": p, "max_new_tokens": 1}
            out = h.remote(dict(req)).result(timeout=T)
            assert out["token_ids"] == jax_ref(p, n=1)
            assert _collect_stream(h, dict(req)) == jax_ref(p, n=1)
        stats = ray_tpu_torch.get(
            [r.handle_request.remote("stats", (), {})
             for r in _decode_replicas("b1dis")], timeout=30)
        assert [s["requests"] for s in stats] == [0, 0]
    finally:
        _delete("b1dis")


def test_serve_disagg_stream_reroute_on_decode_death(cluster, weights,
                                                     jax_ref):
    """Kill the decode replicas after the stream has delivered three
    tokens: the retained handoff re-routes to a (re-spawned or surviving)
    decode replica and the consumer sees one token-identical stream."""
    h = _deploy(weights, "skdis")
    try:
        p = PROMPTS[1]
        ref = jax_ref(p, n=16)
        got = []
        deadline = time.time() + 240
        for t in h.options("stream", stream=True).remote(
                {"prompt_ids": p, "max_new_tokens": 16}):
            got.append(int(t))
            assert time.time() < deadline, "stream stalled"
            if len(got) == 3:
                for rep in _decode_replicas("skdis"):
                    ray_tpu_torch.kill(rep)
        assert got == ref
    finally:
        _delete("skdis")


def test_serve_disagg_equivalence_and_reroute_on_death(cluster, weights,
                                                      jax_ref):
    """One of two decode replicas killed: its edges die, and later
    requests re-route to the survivor (or its replacement) with the same
    tokens."""
    h = _deploy(weights, "eqdis")
    try:
        for p in PROMPTS:
            out = h.remote({"prompt_ids": p,
                            "max_new_tokens": NEW}).result(timeout=T)
            assert out["token_ids"] == jax_ref(p), p
        replicas = _decode_replicas("eqdis")
        assert len(replicas) == 2
        ray_tpu_torch.kill(replicas[0])
        for trip in range(3):
            for p in PROMPTS:
                out = h.remote({"prompt_ids": p, "max_new_tokens": NEW}
                               ).result(timeout=180)
                assert out["token_ids"] == jax_ref(p), (trip, p)
    finally:
        _delete("eqdis")
