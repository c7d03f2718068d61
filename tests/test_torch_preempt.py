"""Priority preemption in the port's engine against ``ray_tpu`` on the
CPU, on the same weights.

The engine-tier cases of ``tests/test_serve_qos.py``: a slot-starved
higher-priority arrival parks the active low-priority request, which
resumes as a continuation; BOTH requests give the greedy tokens
``ray_tpu``'s engine gives them alone, and a stream spans the park. Also
the port's own guard: a fault in a tick fails parked requests too. Left
out: the ``RTPU_DEBUG_RES`` parked-KV balance case (the witness is not
ported) and the WFQ/SLO units (the serve tier, not ported).
"""

import time

import jax
import numpy as np
import pytest

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.llm import LLMEngine as TEngine

BASE = dict(max_batch=1, max_len=96, prompt_buckets=[8, 16, 32],
            decode_chunk=4)
LO, HI = [5, 9, 2, 7, 7, 1], list(range(1, 17))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tllama.tiny_config(max_seq_len=128)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """ray_tpu's engine, each request alone: greedy tokens by (prompt,
    budget)."""
    eng = JEngine(tiny[0], tiny[1], **BASE)
    memo = {}

    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = eng.generate(prompt, max_new_tokens=n)["token_ids"]
        return memo[key]

    yield ref
    eng.close()


def _engine(tiny, **kw):
    return TEngine(tiny[2], tiny[3], device="cpu", **dict(BASE, **kw))


def _when_active(eng, req, timeout=60.0):
    deadline = time.time() + timeout
    while not any(r is req for r in eng.scheduler.active):
        assert time.time() < deadline, "request never activated"
        time.sleep(0.001)


@pytest.mark.parametrize("multi_step", [True, False])
def test_priority_preemption_park_resume_token_identity(tiny, jax_ref,
                                                        multi_step):
    """The preemptor must not inherit the victim's in-flight chunk or KV
    rows (the recycled-slot hazard), and the victim's resume replays its
    remaining budget: both give ray_tpu's solo tokens."""
    eng = _engine(tiny, multi_step=multi_step)
    try:
        lo = eng._make_request(LO, 40, None, priority=0)
        eng._queue.put(lo)
        _when_active(eng, lo)
        hi = eng._make_request(HI, 8, None, priority=5)
        eng._queue.put(hi)
        out_hi = hi.future.result(timeout=60)
        out_lo = lo.future.result(timeout=60)
        st = eng.stats()
    finally:
        eng.close()
    assert st["preempts"] >= 1 and st["resumes"] >= 1
    assert st["parked"] == 0
    assert out_hi["token_ids"] == jax_ref(HI, 8)
    assert out_lo["token_ids"] == jax_ref(LO, 40)
    assert out_lo["num_generated"] == 40
    assert out_lo.get("preempted", 0) >= 1


def test_preemption_streams_survive_park_resume(tiny, jax_ref):
    """The victim's stream spans the park: one uninterrupted sequence,
    ray_tpu's solo tokens (the continuation shares the stream queue)."""
    eng = _engine(tiny)
    try:
        lo = eng._make_request(LO, 40, None, stream=True, priority=0)
        eng._queue.put(lo)
        got, hi = [], None
        deadline = time.time() + 120
        while True:
            kind, val = lo.stream_queue.get(timeout=60)
            if kind == "done":
                break
            if kind == "error":
                raise val
            got.append(val)
            if hi is None:  # first streamed token: lo just activated
                hi = eng._make_request(HI, 8, None, priority=5)
                eng._queue.put(hi)
            assert time.time() < deadline
        assert hi is not None
        hi.future.result(timeout=60)
        preempts = eng.stats()["preempts"]
    finally:
        eng.close()
    assert preempts >= 1
    assert got == jax_ref(LO, 40)


def test_equal_priorities_never_preempt(tiny, jax_ref):
    """All-equal priorities (the default) are plain FIFO: the second
    request waits for the slot."""
    eng = _engine(tiny)
    try:
        a = eng._make_request(LO, 20, None)
        eng._queue.put(a)
        _when_active(eng, a)
        b = eng._make_request(HI, 8, None)
        eng._queue.put(b)
        out_a, out_b = (r.future.result(timeout=60) for r in (a, b))
        st = eng.stats()
    finally:
        eng.close()
    assert st["preempts"] == 0 and st["resumes"] == 0
    assert out_a["token_ids"] == jax_ref(LO, 20)
    assert out_b["token_ids"] == jax_ref(HI, 8)


def test_tick_fault_fails_parked_requests(tiny, jax_ref):
    """A host-side fault in a tick fails the roster AND the parked
    requests (the port's guard; ray_tpu's engine loop has none): no
    caller waits out its timeout, and the engine serves on."""
    eng = _engine(tiny)
    real = eng._decode_tick

    def faulty():
        if eng._parked:
            raise RuntimeError("tick fault")
        real()

    eng._decode_tick = faulty
    try:
        lo = eng._make_request(LO, 80, None, priority=0)
        eng._queue.put(lo)
        _when_active(eng, lo)
        hi = eng._make_request(HI, 8, None, priority=5)
        eng._queue.put(hi)
        for r in (hi, lo):
            with pytest.raises(RuntimeError, match="tick fault"):
                r.future.result(timeout=60)
        assert eng.stats()["parked"] == 0
        eng._decode_tick = real
        out = eng.generate(LO, max_new_tokens=8, timeout=60)
    finally:
        eng.close()
    assert out["token_ids"] == jax_ref(LO, 8)


def test_preemption_parked_kv_witness_balanced(tiny, monkeypatch):
    """``ray_tpu``'s case of the same name: under RTPU_DEBUG_RES the
    parked_kv ledger balances across a real preempt + resume cycle, and
    the engine's close reports nothing."""
    from ray_tpu_torch.devtools import res_debug

    monkeypatch.setenv("RTPU_DEBUG_RES", "1")
    res_debug.reset()
    try:
        eng = _engine(tiny)
        try:
            lo = eng._make_request(LO, 40, None, priority=0)
            eng._queue.put(lo)
            _when_active(eng, lo)
            hi = eng._make_request(HI, 8, None, priority=5)
            eng._queue.put(hi)
            hi.future.result(timeout=60)
            lo.future.result(timeout=60)
        finally:
            eng.close()
        assert eng._preempts >= 1 and eng._resumes >= 1
        assert res_debug.counts()["parked_kv"]["acquired"] >= 1
        assert res_debug.outstanding("parked_kv") == {}
        assert res_debug.violations() == []
    finally:
        res_debug.reset()
