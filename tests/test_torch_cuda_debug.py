"""The port's CUDA witness (``ray_tpu_torch/devtools/cuda_debug.py``,
``RTPU_DEBUG_CUDA=1``), case for case with ``tests/test_jax_debug.py``
(``ray_tpu``'s ``RTPU_DEBUG_JAX=1`` witness), on the CPU.

The signature witness counts what a jit would have compiled; the engine
cases drive one request sequence through ``ray_tpu``'s engine (its
witness on) and through the port's (this witness on), from one seeded
parameter tree, and the port must give ``ray_tpu``'s ``program_counts()``
and ``host_sync_counts()``: one decode chunk signature, one verify
signature iff speculation is on, one prefill signature per prompt bucket
used, and exactly one counted fetch per decode chunk and per admission.
``ray_tpu``'s transfer guard has no CPU counterpart here (the sync guard
acts on a card only); ``tests/test_torch_cuda.py`` holds it on the card.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from ray_tpu.devtools import jax_debug
from ray_tpu_torch.devtools import cuda_debug

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture
def debug_cuda(monkeypatch):
    monkeypatch.setenv("RTPU_DEBUG_CUDA", "1")
    monkeypatch.setenv("RTPU_DEBUG_JAX", "1")
    cuda_debug.reset()
    jax_debug.reset()
    yield
    cuda_debug.reset()
    jax_debug.reset()


# ------------------------------------------------------------ unit layer


def test_wrap_program_passthrough_when_disabled(monkeypatch):
    monkeypatch.delenv("RTPU_DEBUG_CUDA", raising=False)
    fn = object()
    assert cuda_debug.wrap_program(fn, "x") is fn
    cuda_debug.note_host_sync("x")
    assert cuda_debug.host_sync_counts() == {}


def test_signature_witness_counts_and_budget(debug_cuda):
    f = cuda_debug.wrap_program(lambda x: x + 1, "t.f", budget=1)
    f(torch.zeros(2))
    f(torch.ones(2))                   # same signature
    assert f.program_count == 1
    assert cuda_debug.over_budget_reports() == []
    f(torch.zeros(3))                  # new shape: second signature
    assert f.program_count == 2
    reports = cuda_debug.over_budget_reports()
    assert len(reports) == 1
    assert reports[0]["name"] == "t.f" and reports[0]["budget"] == 1
    assert cuda_debug.program_counts()["t.f"] == 2


def test_signature_tracks_dtype_and_structure(debug_cuda):
    f = cuda_debug.wrap_program(lambda t: t, "t.sig")
    f((torch.zeros(2),))
    f((torch.zeros(2, dtype=torch.int32),))         # dtype change
    f((torch.zeros(2), torch.zeros(2)))             # structure
    f((torch.ones(2),))                             # seen before
    assert f.program_count == 3
    # The same calls through ray_tpu's witness give the same count.
    import jax

    g = jax_debug.wrap_jit(jax.jit(lambda t: t), "t.sig")
    g((np.zeros(2, np.float32),))
    g((np.zeros(2, np.int32),))
    g((np.zeros(2, np.float32), np.zeros(2, np.float32)))
    g((np.ones(2, np.float32),))
    assert g.program_count == f.program_count


def test_registry_does_not_pin_dead_witnesses(debug_cuda):
    f = cuda_debug.wrap_program(lambda x: x + 1, "t.dead")
    f(torch.zeros(2))
    assert cuda_debug.program_counts()["t.dead"] == 1
    del f
    gc.collect()
    assert "t.dead" not in cuda_debug.program_counts()


def test_host_sync_counter(debug_cuda):
    cuda_debug.note_host_sync("engine.decode")
    cuda_debug.note_host_sync("engine.decode")
    cuda_debug.note_host_sync("engine.prefill")
    assert cuda_debug.host_sync_counts() == {"engine.decode": 2,
                                             "engine.prefill": 1}


def test_sync_guard_is_null_off_the_card(debug_cuda, monkeypatch):
    """The CPU counterpart of ray_tpu's transfer-guard case: on a CPU
    device the tick guard never touches torch.cuda (this build has no
    CUDA), and allow_sync is null outside a guard."""
    monkeypatch.setenv("RTPU_DEBUG_CUDA_SYNC", "error")
    with cuda_debug.tick_guard(torch.device("cpu")):
        with cuda_debug.allow_sync():
            torch.zeros(2).sum().item()
    with cuda_debug.tick_guard("cpu"):
        pass


def test_tick_guard_null_when_unconfigured(monkeypatch):
    monkeypatch.delenv("RTPU_DEBUG_CUDA", raising=False)
    monkeypatch.setenv("RTPU_DEBUG_CUDA_SYNC", "error")
    with cuda_debug.tick_guard("cuda"):
        pass  # null context: witness off
    monkeypatch.setenv("RTPU_DEBUG_CUDA", "1")
    monkeypatch.delenv("RTPU_DEBUG_CUDA_SYNC", raising=False)
    with cuda_debug.tick_guard("cuda"):
        pass  # still null: no guard level requested


# ------------------------------------------------------- engine layer


@pytest.fixture(scope="module")
def tiny():
    import jax

    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.models import llama as tllama

    jcfg = jllama.tiny_config(max_seq_len=256)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_config(max_seq_len=256)
    tparams = tllama.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(jparams)), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _engines(tiny, **kw):
    from ray_tpu.serve.engine.core import InferenceEngine as JEngine
    from ray_tpu_torch.serve.engine.core import InferenceEngine as TEngine

    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 128)
    kw.setdefault("prompt_buckets", [16, 32])
    kw.setdefault("decode_chunk", 4)
    return (JEngine(tiny[0], tiny[1], **kw),
            TEngine(tiny[2], tiny[3], device="cpu", **kw))


def _drive(eng, reps: int = 2):
    """Two prompt lengths (both buckets), a repetitive prompt (so spec
    engines draft) and a varied one, repeated."""
    rng = np.random.default_rng(0)
    tokens = []
    for _ in range(reps):
        tokens.append(eng.generate([7] * 12, max_new_tokens=16)[
            "token_ids"])
        tokens.append(eng.generate(
            [int(t) for t in rng.integers(1, 200, 24)],
            max_new_tokens=8)["token_ids"])
    return tokens


@pytest.mark.parametrize("workload", ["plain", "spec", "spec_int8"])
def test_steady_state_programs_and_sync_cadence(debug_cuda, tiny,
                                                workload):
    kw = {}
    if workload != "plain":
        kw.update(spec_draft_len=4)
    if workload == "spec_int8":
        kw.update(quantize="int8")
    jeng, teng = _engines(tiny, **kw)
    try:
        want = _drive(jeng)
        got = _drive(teng)
        assert got == want
        first = teng.loop.program_counts()
        _drive(teng, reps=1)                  # steady state: no growth
        programs = teng.loop.program_counts()
        _drive(jeng, reps=1)
        assert programs == first
        assert programs == jeng.loop.program_counts()
        assert programs["decode_chunk"] == 1
        assert programs["prefill"] == 2       # both buckets exercised
        assert ("verify_chunk" in programs) == (workload != "plain")
        assert cuda_debug.over_budget_reports() == []
        stats = teng.stats()
        assert stats["compiled_programs"] == programs
        syncs = cuda_debug.host_sync_counts()
        assert syncs == jax_debug.host_sync_counts()
        assert stats["decode_host_syncs"] > 0
        assert syncs.get("engine.decode", 0) == stats["decode_host_syncs"]
        assert syncs.get("engine.prefill", 0) == stats["requests"]
        if workload != "plain":
            assert stats["spec_chunks"] > 0
    finally:
        jeng.close()
        teng.close()


def test_chunked_paged_engine_declared_schedule(debug_cuda, tiny):
    jeng, teng = _engines(tiny, prefill_chunk=16, paged_decode=True,
                          prefix_block=16, multi_step=True)
    try:
        for eng in (jeng, teng):
            out = eng.generate([3] * 40, max_new_tokens=12)
            assert out["num_generated"] == 12
            assert eng.generate([9, 8, 7], max_new_tokens=9)[
                "num_generated"] == 9
            first = eng.loop.program_counts()
            eng.generate([3] * 40, max_new_tokens=4)
            assert eng.loop.program_counts() == first
        programs = teng.loop.program_counts()
        assert programs == jeng.loop.program_counts()
        assert programs["decode_chunk"] == 1 and programs["prefill"] == 1
        assert cuda_debug.over_budget_reports() == []
        stats = teng.stats()
        syncs = cuda_debug.host_sync_counts()
        assert syncs == jax_debug.host_sync_counts()
        assert syncs.get("engine.decode", 0) == stats["decode_host_syncs"]
        assert syncs.get("engine.prefill", 0) == stats["requests"] == 3
        assert stats["prefill_tokens"] + stats[
            "prefix_tokens_reused"] == 83
    finally:
        jeng.close()
        teng.close()


def test_guarded_engine_tick_clean_on_cpu(debug_cuda, tiny, monkeypatch):
    """With the sync guard requested, a spec engine on the CPU serves as
    without it (the guard applies on a card only) and counts its
    fetches."""
    from ray_tpu_torch.serve.engine.core import InferenceEngine

    monkeypatch.setenv("RTPU_DEBUG_CUDA_SYNC", "error")
    eng = InferenceEngine(tiny[2], tiny[3], device="cpu", max_batch=2,
                          max_len=128, prompt_buckets=[16, 32],
                          decode_chunk=4, spec_draft_len=4)
    try:
        assert sum(len(t) for t in _drive(eng, reps=1)) > 0
        assert cuda_debug.host_sync_counts().get("engine.decode", 0) > 0
    finally:
        eng.close()


def test_flag_off_engine_is_unwrapped(monkeypatch, tiny):
    from ray_tpu_torch.serve.engine.core import InferenceEngine
    from ray_tpu_torch.serve.engine.decode_loop import DecodeLoop

    monkeypatch.delenv("RTPU_DEBUG_CUDA", raising=False)
    eng = InferenceEngine(tiny[2], tiny[3], device="cpu", max_batch=2,
                          max_len=128, prompt_buckets=[16, 32],
                          decode_chunk=4)
    try:
        assert eng.loop.program_counts() == {}
        assert "decode_chunk" not in eng.loop.__dict__
        assert eng.loop.decode_chunk.__func__ is DecodeLoop.decode_chunk
        out = eng.generate([5, 6, 7], max_new_tokens=4)
        assert out["num_generated"] == 4
        assert "compiled_programs" not in eng.stats()
    finally:
        eng.close()


# ------------------------------------------------------- trainer layer


def test_train_step_single_program_budget(debug_cuda):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    cfg = llama.tiny_config(max_seq_len=64)
    tx = spmd.default_optimizer(1e-3)
    state = spmd.init_train_state(cfg, torch.Generator().manual_seed(0),
                                  tx, device="cpu")
    step = spmd.make_train_step(cfg, tx)
    tokens = torch.zeros((2, 64), dtype=torch.int32)
    for _ in range(3):
        state, _metrics = step(state, tokens)
    assert cuda_debug.program_counts()["spmd.train_step"] == 1
    assert cuda_debug.over_budget_reports() == []
    state, _metrics = step(state, torch.zeros((4, 64), dtype=torch.int32))
    assert cuda_debug.program_counts()["spmd.train_step"] == 2
    reports = cuda_debug.over_budget_reports()
    assert [r["name"] for r in reports] == ["spmd.train_step"]
