"""The port's speculative decoding against ``ray_tpu``'s on the CPU.

- ``drafter``: ``PromptLookupDrafter`` and ``SpecControl`` units (the
  port's copy must behave as ray_tpu's; test_serve_engine_spec.py:56-102).
- ``DecodeLoop.verify_chunk`` against ray_tpu's on the same weights,
  cache and drafts: full, partial and no acceptance, an EOS and the row
  cap inside a window, and a parked (done) slot. ``emits``, ``counts``,
  ``lengths`` and ``done`` are equal and the cache rows below ``max_len``
  agree within 1e-4 (f32).
- ``LLMEngine`` with speculation against itself without it and against
  ray_tpu's speculative engine: greedy tokens identical, including an EOS
  inside a verify window and the ``max_len`` row cap.
"""

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
from ray_tpu_torch.serve.engine.drafter import (PromptLookupDrafter,
                                                SpecControl)
from ray_tpu_torch.serve.llm import LLMEngine as TEngine


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=64)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tllama.tiny_config(max_seq_len=64)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


# ------------------------------------------------------------------ drafter


def test_prompt_lookup_drafter():
    d = PromptLookupDrafter(ngram_max=3)
    assert d.draft([1, 5, 6, 9, 2, 5, 6], 2) == [9, 2]
    assert d.draft([5, 6, 1, 5, 6, 2, 5, 6], 1) == [2]
    assert d.draft([7, 8, 7, 8], 6) == [7, 8, 7, 8, 7, 8]
    assert d.draft([3, 3, 3, 3], 5) == [3, 3, 3, 3, 3]
    assert d.draft([1, 2, 3, 4, 5], 4) == []
    assert d.draft([1], 4) == []
    assert d.draft([1, 2, 1], 0) == []
    with pytest.raises(ValueError):
        PromptLookupDrafter(ngram_max=0)


def test_spec_control_adaptive():
    c = SpecControl(allowance=4, max_allowance=16, bad_limit=2,
                    probe_interval=4)
    assert c.budget() == 4
    c.observe(4, 4)
    assert c.allowance == 8
    c.observe(8, 8)
    assert c.allowance == 16
    c.observe(16, 5)
    assert c.allowance == 16
    c.observe(16, 0)
    assert c.allowance == 8
    c.observe(8, 0)
    assert c.allowance == 0
    probes = [c.budget() for _ in range(8)]
    assert probes.count(1) == 2 and probes.count(0) == 6
    c.observe(1, 1)
    assert c.allowance == 2
    c.observe(2, 0)
    c.observe(2, 2)
    c.observe(4, 0)
    assert c.allowance >= 1
    m = SpecControl(allowance=4, max_allowance=16, bad_limit=3,
                    probe_interval=8)
    for _ in range(3):
        assert m.budget() > 0
        m.miss()
    assert m.allowance == 0
    assert sum(1 for _ in range(16) if m.budget() > 0) == 2


# ------------------------------------------------------------- verify_chunk


def test_verify_chunk_matches_jax(tiny):
    """Four slots, window W=3 (K=2), two iterations per chunk:
    slot 0 accepts its first window in full, then one draft of two;
    slot 1 drafts the true continuation and reaches the max_len row cap
    inside its second window; slot 2 is inactive (parks its window in the
    scratch strip); slot 3 drafts the true continuation but its EOS lands
    inside the first window, so accepted drafts past it are not emitted."""
    jcfg, jparams, tcfg, tparams = tiny
    max_len, w, c = 24, 3, 2
    jl = JDecodeLoop(jcfg, max_len=max_len, chunk=4, spec_window=w,
                     spec_chunk=c)
    tl = TDecodeLoop(tcfg, tparams, max_len=max_len, chunk=4,
                     spec_window=w, spec_chunk=c)
    assert tl.scratch_rows == jl.scratch_rows == w
    rows = max_len + tl.scratch_rows
    jcache = jllama.init_kv_cache(jcfg, 4, rows)
    tcache = tllama.init_kv_cache(tcfg, 4, rows, device="cpu")
    rng = np.random.RandomState(3)
    lens = {0: 5, 1: 18, 3: 7}
    first = np.zeros(4, np.int32)
    for slot, n in lens.items():
        padded = np.zeros((1, 8 if n <= 8 else 24), np.int32)
        padded[0, :n] = rng.randint(0, 256, n)
        jlog, jcache = jl.prefill(jparams, jcache, jnp.asarray(padded),
                                  jnp.int32(slot), jnp.int32(0))
        tl.prefill(tcache, torch.from_numpy(padded), slot, 0)
        first[slot] = int(np.argmax(np.asarray(jlog)[0, n - 1]))
    lengths = np.array([5, 18, max_len - 1, 7], np.int32)
    done = np.array([False, False, True, False])
    # The greedy continuation of every slot, from ray_tpu's plain chunk.
    free = np.asarray(JDecodeLoop(jcfg, max_len=max_len, chunk=8)
                      .decode_chunk(jparams, jcache,
                                    jnp.asarray(first[:, None]),
                                    jnp.asarray(lengths),
                                    jnp.full((4,), 20, jnp.int32),
                                    jnp.full((4,), -1, jnp.int32),
                                    jnp.asarray(done))[0])
    drafts = np.zeros((4, c, w - 1), np.int32)
    for slot in (0, 1, 3):   # rows packed at stride W (bonus skipped)
        drafts[slot, 0] = free[slot, 0:2]
        drafts[slot, 1] = free[slot, 3:5]
    drafts[0, 1, 1] = (free[0, 4] + 1) % 256
    ndraft = np.array([4, 4, 0, 4], np.int32)
    eos = np.full(4, -1, np.int32)
    eos[3] = free[3, 1]
    args = [first[:, None], drafts, ndraft, lengths,
            np.array([20, 20, 0, 20], np.int32), eos, done]
    jout = jl.verify_chunk(jparams, jcache, *map(jnp.asarray, args))
    tout = tl.verify_chunk(tcache, *(torch.from_numpy(a.copy())
                                     for a in args))
    for a, b in zip(jout[:4], tout[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    counts, done_out = tout[1].numpy(), tout[3].numpy()
    assert counts[0].tolist() == [3, 2] and not done_out[0]
    assert counts[1].tolist() == [3, 2] and done_out[1]
    assert counts[2].tolist() == [0, 0]
    eos_at = list(free[3]).index(eos[3])
    assert counts[3].tolist() == [eos_at + 1, 0] and done_out[3]
    np.testing.assert_array_equal(tout[0][0, 0].numpy(), free[0, :3])
    np.testing.assert_allclose(tcache["k"][:, :, :, :max_len].numpy(),
                               np.asarray(jout[4]["k"])[:, :, :, :max_len],
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ engine


def _engines(tiny, **kw):
    jcfg, jparams, tcfg, tparams = tiny
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prompt_buckets", [8, 16])
    kw.setdefault("decode_chunk", 4)
    return (JEngine(jcfg, jparams, **kw),
            TEngine(tcfg, tparams, device="cpu", **kw))


@pytest.fixture(scope="module")
def engines(tiny):
    spec = dict(spec_draft_len=4, spec_chunk=2, spec_ngram_max=4)
    jspec, tspec = _engines(tiny, **spec)
    tplain = TEngine(tiny[2], tiny[3], device="cpu", max_batch=2,
                     max_len=64, prompt_buckets=[8, 16], decode_chunk=4)
    yield jspec, tspec, tplain
    for e in (jspec, tspec, tplain):
        e.close()


def test_spec_engine_matches_plain_and_jax(engines):
    jspec, tspec, tplain = engines
    for prompt in ([1, 2, 3, 4, 5], [9, 8, 7], [5] * 8, [16] * 10):
        for n in (1, 6, 20):
            a = tplain.generate(prompt, max_new_tokens=n)["token_ids"]
            b = tspec.generate(prompt, max_new_tokens=n)
            assert b["token_ids"] == a, (prompt, n)
            assert b["num_generated"] == n
            assert jspec.generate(prompt, max_new_tokens=n)[
                "token_ids"] == a
    stats = tspec.stats()
    assert stats["spec_chunks"] > 0 and stats["spec_accepted"] > 0
    assert 0.0 < stats["spec_accept_rate"] <= 1.0
    assert stats["dispatches"]["verify"] == stats["spec_chunks"]
    assert tspec.kv.used_blocks() == 0
    assert all(s.spec_rows == 0 for s in tspec.kv._slots)


def test_spec_eos_mid_window_matches_jax(engines):
    jspec, tspec, tplain = engines
    prompt = [3, 1, 4, 1, 5]
    free = tplain.generate(prompt, max_new_tokens=24)["token_ids"]
    cut = [k for k in (2, 5, 9) if free.index(free[k]) == k]
    assert cut
    for k in cut:
        want = free[:k + 1]
        kw = dict(max_new_tokens=24, eos_id=free[k])
        assert tspec.generate(prompt, **kw)["token_ids"] == want
        assert list(tspec.generate_stream(prompt, **kw)) == want
        assert jspec.generate(prompt, **kw)["token_ids"] == want


def test_spec_row_cap_matches_jax(engines):
    """A generation that runs into max_len freezes at the same token with
    and without speculation (its windows overrun into the scratch strip,
    never back onto valid rows)."""
    jspec, tspec, tplain = engines
    prompt = [16] * 38
    a = tplain.generate(prompt, max_new_tokens=26)["token_ids"]
    assert tspec.generate(prompt, max_new_tokens=26)["token_ids"] == a
    assert jspec.generate(prompt, max_new_tokens=26)["token_ids"] == a
    assert tspec.cache["k"].shape[3] == 64 + 5


def test_oracle_drafts_fill_every_window(tiny):
    """Rows packed at stride draft_len+1: with drafts of the true
    continuation, every window of every chunk accepts in full."""
    _, _, tcfg, tparams = tiny
    eng = TEngine(tcfg, tparams, device="cpu", max_batch=1, max_len=64,
                  prompt_buckets=[8, 16], decode_chunk=4, spec_draft_len=3,
                  spec_chunk=2)
    prompt = [3, 1, 4, 1, 5]
    try:
        free = eng.generate(prompt, max_new_tokens=33)["token_ids"]

        class Oracle:
            def draft(self, context, need):
                g = len(context) - len(prompt)
                return free[g:g + need]

        eng.drafter = Oracle()
        m0 = dict(eng.metrics.snapshot())
        out = eng.generate(prompt, max_new_tokens=33)
        m1 = eng.metrics.snapshot()
    finally:
        eng.close()
    assert out["token_ids"] == free
    drafted = m1["spec_drafted"] - m0["spec_drafted"]
    assert drafted > 0 and m1["spec_accepted"] - m0["spec_accepted"] == \
        drafted
    assert m1["decode_host_syncs"] - m0["decode_host_syncs"] <= 6


def test_host_fault_in_a_tick_fails_its_request_and_serving_goes_on(tiny):
    """A fault on the host side of a tick (here the drafter) fails the
    requests in flight at once instead of killing the engine thread and
    leaving callers to wait out their timeout; the next request is
    served and no slot stays held."""
    _, _, tcfg, tparams = tiny
    eng = TEngine(tcfg, tparams, device="cpu", max_batch=2, max_len=64,
                  prompt_buckets=[8, 16], decode_chunk=4, spec_draft_len=2,
                  spec_chunk=2)

    class Broken:
        def draft(self, context, need):
            raise RuntimeError("drafter fault")

    try:
        want = eng.generate([1, 2, 3], max_new_tokens=6, timeout=60)
        real, eng.drafter = eng.drafter, Broken()
        with pytest.raises(RuntimeError, match="drafter fault"):
            eng.generate([1, 2, 3], max_new_tokens=6, timeout=60)
        with pytest.raises(RuntimeError, match="drafter fault"):
            list(eng.generate_stream([4, 5], max_new_tokens=6, timeout=60))
        eng.drafter = real
        got = eng.generate([1, 2, 3], max_new_tokens=6, timeout=60)
        assert eng.scheduler.active == [] and eng.kv.used_blocks() == 0
    finally:
        eng.close()
    assert got["token_ids"] == want["token_ids"]
