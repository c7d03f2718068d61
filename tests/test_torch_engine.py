"""The port's serving engine (``ray_tpu_torch.serve``) against ``ray_tpu``'s
on the CPU, on the same weights.

``DecodeLoop`` is held against ray_tpu's program by program (prefill, the
K-step chunk with its stop rule and ``n_valid``), and ``LLMEngine`` request
by request: greedy tokens must be identical, with concurrent requests,
prefix-cache reuse, multi-step ticks on and off, and EOS, budget and
``max_len`` stops that land inside a chunk.
"""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.serve.engine.decode_loop import DecodeLoop as JDecodeLoop
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.engine.decode_loop import DecodeLoop as TDecodeLoop
from ray_tpu_torch.serve.llm import LLMEngine as TEngine


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=64)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tllama.tiny_config(max_seq_len=64)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


def _engines(tiny, **kw):
    jcfg, jparams, tcfg, tparams = tiny
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prompt_buckets", [8, 16])
    return (JEngine(jcfg, jparams, **kw),
            TEngine(tcfg, tparams, device="cpu", **kw))


def _run(engine, calls, workers=1):
    """Each call is (prompt, kwargs); returns generate() results in order."""
    if workers == 1:
        return [engine.generate(p, **k) for p, k in calls]
    with cf.ThreadPoolExecutor(workers) as pool:
        futs = [pool.submit(engine.generate, p, **k) for p, k in calls]
        return [f.result(timeout=300) for f in futs]


def _both(tiny, calls, workers=1, **kw):
    engines = _engines(tiny, **kw)
    try:
        return [_run(e, calls, workers) for e in engines] + [engines[1]]
    finally:
        for e in engines:
            e.close()


# ------------------------------------------------------------ decode loop


def test_decode_loop_prefill_and_chunks_match_jax(tiny):
    """Program by program against ray_tpu's DecodeLoop: bucket-padded
    prefill into two slots, then chunks whose stops land mid-chunk — a
    budget (slot 0), the row cap max_len (slot 1) — beside an inactive
    slot parked on the last row (slot 2). Tokens, n_valid and the carried
    state must be identical."""
    jcfg, jparams, tcfg, tparams = tiny
    max_len, k = 24, 4
    jl = JDecodeLoop(jcfg, max_len=max_len, chunk=k)
    tl = TDecodeLoop(tcfg, tparams, max_len=max_len, chunk=k)
    jcache = jllama.init_kv_cache(jcfg, 3, max_len)
    tcache = tllama.init_kv_cache(tcfg, 3, max_len, device="cpu")
    rng = np.random.RandomState(0)
    firsts, lens = [], [5, 21]
    for slot, n in enumerate(lens):
        padded = np.zeros((1, 8 if n <= 8 else 24), np.int32)
        padded[0, :n] = rng.randint(0, 256, n)
        jlog, jcache = jl.prefill(jparams, jcache, jnp.asarray(padded),
                                  jnp.int32(slot), jnp.int32(0))
        tlog, tcache = tl.prefill(tcache, torch.from_numpy(padded), slot, 0)
        first = int(np.argmax(np.asarray(jlog)[0, n - 1]))
        assert int(tlog[0, n - 1].argmax()) == first
        firsts.append(first)
    state = dict(tokens=np.array([[firsts[0]], [firsts[1]], [0]], np.int32),
                 lengths=np.array([5, 21, max_len - 1], np.int32),
                 remaining=np.array([6, 30, 0], np.int32),
                 eos_ids=np.full(3, -1, np.int32),
                 done=np.array([False, False, True]))
    jstate = {n: jnp.asarray(a) for n, a in state.items()}
    tstate = {n: torch.from_numpy(a.copy()) for n, a in state.items()}
    names = ("tokens", "lengths", "remaining", "done")
    for _ in range(3):
        jout = jl.decode_chunk(jparams, jcache, *jstate.values())
        tout = tl.decode_chunk(tcache, *tstate.values())
        jcache, tcache = jout[-1], tout[-1]
        for a, b in zip(jout[:-1], tout[:-1]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        jstate.update(zip(names, jout[2:6]))
        tstate.update(zip(names, tout[2:6]))
    n_valid = tout[1].numpy()
    assert n_valid[2] == 0
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               rtol=1e-4, atol=1e-4)


def test_decode_loop_eos_freezes_mid_chunk(tiny):
    """A slot whose EOS appears mid-chunk stops there: n_valid counts the
    EOS, later positions repeat it, and its length stops advancing —
    identically in both loops."""
    jcfg, jparams, tcfg, tparams = tiny
    jl = JDecodeLoop(jcfg, max_len=32, chunk=6)
    tl = TDecodeLoop(tcfg, tparams, max_len=32, chunk=6)
    jcache = jllama.init_kv_cache(jcfg, 1, 32)
    tcache = tllama.init_kv_cache(tcfg, 1, 32, device="cpu")
    padded = np.zeros((1, 8), np.int32)
    padded[0, :4] = [3, 1, 4, 1]
    jlog, jcache = jl.prefill(jparams, jcache, jnp.asarray(padded),
                              jnp.int32(0), jnp.int32(0))
    tl.prefill(tcache, torch.from_numpy(padded), 0, 0)
    first = int(np.argmax(np.asarray(jlog)[0, 3]))
    args = [np.array([[first]], np.int32), np.array([4], np.int32),
            np.array([20], np.int32), np.array([-1], np.int32),
            np.array([False])]
    free = np.asarray(jl.decode_chunk(jparams, jcache,
                                      *map(jnp.asarray, args))[0])[0]
    j = next(i for i in range(1, 5) if free[i] not in free[:i])
    args[3] = np.array([free[j]], np.int32)
    jout = jl.decode_chunk(jparams, jcache, *map(jnp.asarray, args))
    tout = tl.decode_chunk(tcache, *(torch.from_numpy(a) for a in args))
    for a, b in zip(jout[:-1], tout[:-1]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(tout[1][0]) == j + 1
    assert bool(tout[5][0])


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("multi_step", [True, False])
def test_concurrent_requests_match_jax_engine(tiny, multi_step):
    rng = np.random.RandomState(1)
    calls = [(rng.randint(0, 256, n).tolist(), dict(max_new_tokens=m))
             for n, m in ((5, 9), (12, 7), (3, 20), (16, 4), (9, 13),
                          (7, 1))]
    jres, tres, _ = _both(tiny, calls, workers=4, decode_chunk=4,
                          multi_step=multi_step, max_batch=3)
    for (prompt, kw), a, b in zip(calls, jres, tres):
        assert b["num_generated"] == kw["max_new_tokens"]
        assert b["token_ids"] == a["token_ids"]


def test_prefix_cache_reuse_matches_jax_engine(tiny):
    """A repeated prompt is served from the freed slot's resident rows:
    both engines report the same cached prefix and emit the cold run's
    tokens."""
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    calls = [(prompt, dict(max_new_tokens=8))] * 2
    jres, tres, eng = _both(tiny, calls, max_batch=1, decode_chunk=4,
                            prefix_block=4)
    assert [r["cached_prefix_len"] for r in tres] == [0, 8]
    assert [r["cached_prefix_len"] for r in jres] == [0, 8]
    assert tres[1]["token_ids"] == tres[0]["token_ids"] == jres[0][
        "token_ids"]
    stats = eng.stats()
    assert stats["prefix_hits"] == 1 and stats["prefix_tokens_reused"] == 8
    assert stats["prefill_tokens"] == 9 + 1


def test_prefix_survives_concurrent_decode(tiny):
    """Inactive slots park their writes on the last row, so a freed slot's
    resident prefix outlives other slots' chunks (core.py:1254-1274)."""
    shared = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    eng = TEngine(tiny[2], tiny[3], device="cpu", max_batch=2, max_len=64,
                  prompt_buckets=[8, 16], decode_chunk=4, prefix_block=4)
    try:
        cold = eng.generate(shared, max_new_tokens=6)
        with cf.ThreadPoolExecutor(2) as pool:
            long_run = pool.submit(eng.generate, [11, 12, 13], 24)
            while not eng.scheduler.active:
                pass
            warm = eng.generate(shared, max_new_tokens=6)
            long_run.result(timeout=300)
    finally:
        eng.close()
    assert warm["cached_prefix_len"] == 8
    assert warm["token_ids"] == cold["token_ids"]


@pytest.mark.parametrize("stop", ["eos", "budget", "max_len"])
def test_stops_inside_a_chunk_match_jax_engine(tiny, stop):
    """Each stop rule of decode_chunk landing mid-chunk (chunk 4): the
    frozen overshoot is discarded, never delivered, in both engines."""
    prompt = [3, 1, 4, 1, 5]
    kw = dict(decode_chunk=4)
    if stop == "eos":
        free = _both(tiny, [(prompt, dict(max_new_tokens=12))], **kw)[1][0]
        ids = free["token_ids"]
        i = next(i for i in range(1, 12)
                 if i % 4 in (1, 2) and ids[i] not in ids[:i])
        calls = [(prompt, dict(max_new_tokens=12, eos_id=ids[i]))]
    elif stop == "budget":
        calls = [(prompt, dict(max_new_tokens=6))]
    else:
        # prompt + budget == max_len: the row cap ends the request on its
        # 10th token, the 2nd position of the third chunk.
        kw.update(max_len=32, prompt_buckets=[8, 32])
        calls = [(list(range(1, 23)), dict(max_new_tokens=10))]
    (a,), (b,), eng = _both(tiny, calls, **kw)
    assert b["token_ids"] == a["token_ids"]
    if stop == "eos":
        assert b["token_ids"][-1] == calls[0][1]["eos_id"]
        assert b["num_generated"] == i + 1
    else:
        assert b["num_generated"] == calls[0][1]["max_new_tokens"]
    # one prefill sync per admission, one decode sync per fetched chunk
    assert eng.stats()["host_syncs"]["prefill"] == len(calls)


def test_stream_matches_blocking_and_jax(tiny):
    prompt = [9, 8, 7, 6]
    engines = _engines(tiny, decode_chunk=4)
    try:
        want = engines[0].generate(prompt, max_new_tokens=11)["token_ids"]
        streamed = list(engines[1].generate_stream(prompt, max_new_tokens=11))
    finally:
        for e in engines:
            e.close()
    assert streamed == want


def test_host_sync_cadence_matches_jax(tiny):
    """Token 0 comes from prefill; the other 16 arrive in ceil(16/8) = 2
    fetched chunks, counted the same way as ray_tpu's metrics."""
    jeng, teng = _engines(tiny, decode_chunk=8, multi_step=False)
    try:
        outs = [e.generate([1, 2, 3], max_new_tokens=17) for e in (jeng,
                                                                  teng)]
        assert outs[0]["token_ids"] == outs[1]["token_ids"]
        assert teng.metrics.host_syncs == jeng.metrics.host_syncs == 2
        assert teng.stats()["host_syncs"] == {"prefill": 1, "decode": 2}
    finally:
        jeng.close()
        teng.close()


@pytest.mark.parametrize("knob", [
    dict(role="prefill"), dict(role="decode"),
    dict(kv_fleet_min_prefix_blocks=0), dict(kv_fleet_store=object()),
])
def test_unported_knobs_raise(tiny, knob):
    _, _, tcfg, tparams = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(tcfg, tparams, device="cpu", **knob)


def test_priority_preemption_raises(tiny):
    _, _, tcfg, tparams = tiny
    eng = TEngine(tcfg, tparams, device="cpu", max_batch=1, max_len=64,
                  prompt_buckets=[8, 16])
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.generate([1, 2], max_new_tokens=2, priority=1)
        assert eng.generate([1, 2], max_new_tokens=2)["num_generated"] == 2
        with pytest.raises(ValueError):
            eng.generate([1, 2], max_new_tokens=63)
    finally:
        eng.close()
