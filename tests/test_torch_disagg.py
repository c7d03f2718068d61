"""Disaggregated prefill/decode in the port (``role="prefill"`` /
``"decode"``) against ``ray_tpu`` on the CPU, on the same weights.

``DecodeLoop.export_page``/``install_page`` are held against
``ray_tpu``'s jitted programs on one numpy cache, the clamped starts
included (``jnp.clip`` to S - P, then ``dynamic_update_slice``'s clamp to
S - rows for a run of pages). The engine cases are the store-free ones of
``tests/test_disagg_serve.py``: a port prefill engine's handoff installed
into a port decode engine gives the greedy tokens of ``ray_tpu``'s
colocated engine, its pages match ``ray_tpu``'s prefill handoff, the
decode side's chain hashes equal the prefill side's, and bad handoffs are
refused. Left out: ``test_disagg_engines_close_balanced`` (the
``RTPU_DEBUG_RES`` witness is not ported) and the serve tier (it boots a
cluster).
"""

import threading

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

BASE = dict(max_batch=2, max_len=96, prompt_buckets=[8, 16, 32],
            decode_chunk=4)
PROMPTS = [
    [5, 9, 2, 7, 7, 1],
    [3, 3, 3, 3, 1, 2, 8, 4, 4, 4, 9, 9, 1, 0, 2, 5, 6, 7],
    list(range(1, 33)),  # multi-page prompt (block 16 -> 2 pages)
]


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tllama.tiny_config(max_seq_len=128)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """ray_tpu's colocated engine: greedy tokens by (prompt, budget)."""
    jcfg, jparams, _, _ = tiny
    eng = JEngine(jcfg, jparams, **BASE)
    memo = {}

    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = eng.generate(prompt, max_new_tokens=n)["token_ids"]
        return memo[key]

    yield ref
    eng.close()


def _teng(tiny, **kw):
    return TEngine(tiny[2], tiny[3], device="cpu", **dict(BASE, **kw))


def _pair(tiny, **kw):
    return _teng(tiny, role="prefill", **kw), _teng(tiny, role="decode", **kw)


# ---------------------------------------------------------- page programs


def _caches(tiny, s, dtype="float32", batch=3, seed=0):
    """One random numpy cache [L, B, KH, S, D] as ray_tpu's and the
    port's."""
    cfg = tiny[2]
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim)
    rng = np.random.RandomState(seed)
    k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    return ({"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt)},
            {"k": torch.from_numpy(k).to(tdt),
             "v": torch.from_numpy(v).to(tdt)})


def _loops(tiny, page):
    jcfg, _, tcfg, tparams = tiny
    return (JDecodeLoop(jcfg, max_len=32, chunk=4, kv_page=page),
            TDecodeLoop(tcfg, tparams, max_len=32, chunk=4, kv_page=page))


def _same(t, j):
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("slot,start", [(0, 0), (1, 16), (2, 24), (1, 30),
                                        (0, -5)])
def test_export_page_matches_jax_including_the_clamp(tiny, slot, start):
    """S = 40, P = 16: starts past S - P = 24 (and below 0) clamp as
    ``jnp.clip(start, 0, S - P)`` does."""
    jl, tl = _loops(tiny, 16)
    jcache, tcache = _caches(tiny, 40)
    jk, jv = jl.export_page(jcache, jnp.int32(slot), jnp.int32(start))
    tk, tv = tl.export_page(tcache, slot, start)
    assert tk.shape == tuple(jk.shape) == (2, 2, 16, 16)
    _same(tk, jk)
    _same(tv, jv)
    # A copy, not a view: later cache writes leave the page alone.
    before = tk.clone()
    tcache["k"].fill_(7.0)
    assert torch.equal(tk, before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,start", [(16, 0), (16, 30), (16, -4),
                                        (32, 16), (32, 0), (32, 30)])
def test_install_page_matches_jax_including_both_clamps(tiny, dtype, rows,
                                                        start):
    """One page or a run of two (the fleet pull) written into slot 1 of a
    40-row cache: ``jnp.clip(start, 0, 24)`` first, then
    ``dynamic_update_slice`` clamps a run to S - rows (32 rows asked at 16
    or 30 land at 8). f32 pages are cast to the cache's dtype."""
    jl, tl = _loops(tiny, 16)
    jcache, tcache = _caches(tiny, 40, dtype)
    cfg = tiny[2]
    shape = (cfg.n_layers, cfg.n_kv_heads, rows, cfg.head_dim)
    rng = np.random.RandomState(rows + start + 10)
    kp, vp = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    jcache = jl.install_page(jcache, jnp.asarray(kp), jnp.asarray(vp),
                             jnp.int32(1), jnp.int32(start))
    out = tl.install_page(tcache, torch.from_numpy(kp), torch.from_numpy(vp),
                          1, start)
    assert out is tcache  # in place
    assert tcache["k"].dtype == getattr(torch, dtype)
    _same(tcache["k"], jcache["k"])
    _same(tcache["v"], jcache["v"])


def test_page_programs_refuse_a_slot_jax_would_clamp(tiny):
    """``dynamic_slice`` clamps an out-of-range slot onto the last one;
    the port raises instead (the engine never passes one)."""
    _, tl = _loops(tiny, 16)
    _, tcache = _caches(tiny, 32)
    with pytest.raises(IndexError):
        tl.export_page(tcache, 3, 0)
    with pytest.raises(IndexError):
        tl.install_page(tcache, *tl.export_page(tcache, 0, 0), -1, 0)
    with pytest.raises(RuntimeError, match="kv_page=0"):
        _loops(tiny, 0)[1].export_page(tcache, 0, 0)
    # A run longer than the cache: both refuse.
    run = torch.zeros(2, 2, 48, 16)
    with pytest.raises(ValueError):
        tl.install_page(tcache, run, run, 0, 0)
    jl = _loops(tiny, 16)[0]
    with pytest.raises(TypeError):
        jl.install_page(_caches(tiny, 32)[0], jnp.zeros((2, 2, 48, 16)),
                        jnp.zeros((2, 2, 48, 16)), jnp.int32(0),
                        jnp.int32(0))


# ------------------------------------------------------------ engine tier


@pytest.mark.parametrize("paged_decode", [False, True])
def test_disagg_token_identity_vs_jax_colocated(tiny, jax_ref,
                                                paged_decode):
    pre, dec = _pair(tiny, paged_decode=paged_decode)
    try:
        for p in PROMPTS:
            h = pre.prefill_remote(p, max_new_tokens=20, timeout=60)
            assert h.get("kv_handoff"), h
            out = dec.install_remote(h, timeout=60)
            assert out["token_ids"] == jax_ref(p, 20), p
        pre_stats, dec_stats = pre.stats(), dec.stats()
    finally:
        pre.close()
        dec.close()
    pages = sum(-(-len(p) // 16) for p in PROMPTS)
    # One export a page, one counted sync a handoff; the decode side
    # installs every page and runs every decode chunk.
    assert pre_stats["host_syncs"]["kv_export"] == len(PROMPTS)
    assert pre_stats["dispatches"]["export_page"] == pages
    assert pre_stats["dispatches"]["decode"] == 0
    assert dec_stats["dispatches"]["install_page"] == pages
    assert dec_stats["dispatches"]["prefill"] == 0
    assert dec_stats["host_syncs"]["prefill"] == 0


def test_disagg_handoff_matches_jax_prefill_handoff(tiny):
    """The port's handoff carries ray_tpu's: the same first token, chain,
    rows and block count, and the same pages."""
    jcfg, jparams, _, _ = tiny
    jpre = JEngine(jcfg, jparams, role="prefill", **BASE)
    tpre = _teng(tiny, role="prefill")
    try:
        for p in PROMPTS[1:]:
            want = jpre.prefill_remote(p, max_new_tokens=8)
            got = tpre.prefill_remote(p, max_new_tokens=8, timeout=60)
            for key in ("first_token", "chain", "rows", "page",
                        "prompt_ids", "max_new_tokens", "cached_prefix_len"):
                assert got[key] == want[key], key
            assert len(got["pages_k"]) == len(want["pages_k"])
            # The pages come out of a prefill forward: layer 0's within
            # 1e-5 / 1e-6, deeper layers within the 1e-4 that
            # test_torch_engine.py holds a cache to after a forward (f32
            # products round differently in XLA and PyTorch).
            for name in ("pages_k", "pages_v"):
                for tp, jp in zip(got[name], want[name]):
                    np.testing.assert_allclose(tp[0].numpy(),
                                               np.asarray(jp)[0],
                                               rtol=1e-5, atol=1e-6)
                    np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                               rtol=1e-4, atol=1e-4)
    finally:
        jpre.close()
        tpre.close()


def test_disagg_chain_hashes_equal_on_decode_side(tiny):
    pre, dec = _pair(tiny)
    try:
        p = PROMPTS[2]
        h = pre.prefill_remote(p, max_new_tokens=4, timeout=60)
        assert len(h["chain"]) == len(p) // 16  # complete blocks hashed
        req = dec.install_async(h)
        req.future.result(timeout=60)
        # The install verified the chain; the slot, released with the
        # prompt resident, still carries the prefill side's.
        n = len(h["chain"])
        assert any(dec.kv.slot_chain(s)[:n] == tuple(h["chain"])
                   for s in range(dec.max_batch))
        # A corrupted chain is refused, and the failed install frees its
        # slot.
        h2 = pre.prefill_remote(PROMPTS[1], max_new_tokens=4, timeout=60)
        h2["chain"] = [hash("corrupt")]
        with pytest.raises(RuntimeError, match="chain mismatch"):
            dec.install_remote(h2, timeout=60)
        assert dec.kv.free_slots() == dec.max_batch
    finally:
        pre.close()
        dec.close()


def test_disagg_corrupt_page_bytes_refused(tiny, jax_ref):
    """The CRCs cover the page bytes: a flipped value fails the install
    (the chain, which covers tokens, cannot see it), and the decode engine
    serves the next handoff."""
    pre, dec = _pair(tiny)
    try:
        h = pre.prefill_remote(PROMPTS[1], max_new_tokens=6, timeout=60)
        good = dict(h, pages_k=list(h["pages_k"]))
        bad = h["pages_k"][1].clone()
        bad[0, 0, 0, 0] += 1.0
        h["pages_k"][1] = bad
        with pytest.raises(RuntimeError, match="checksum mismatch"):
            dec.install_remote(h, timeout=60)
        assert dec.kv.free_slots() == dec.max_batch
        out = dec.install_remote(good, timeout=60)
    finally:
        pre.close()
        dec.close()
    assert out["token_ids"] == jax_ref(PROMPTS[1], 6)


def test_disagg_with_chunked_prefill_and_prefix_reuse(tiny, jax_ref):
    """Chunked prefill on the prefill engine + a repeated prompt (the
    prefill side's prefix cache serves the reused blocks) still hands off
    KV that decodes ray_tpu's tokens."""
    pre = _teng(tiny, role="prefill", prefill_chunk=16)
    dec = _teng(tiny, role="decode")
    try:
        p = PROMPTS[2]
        for trip in range(2):  # the second trip hits the prefix cache
            h = pre.prefill_remote(p, max_new_tokens=12, timeout=60)
            out = dec.install_remote(h, timeout=60)
            assert out["token_ids"] == jax_ref(p, 12), trip
        assert pre.kv.hits >= 1
        assert pre.stats()["dispatches"]["prefill"] > 2  # chunked
    finally:
        pre.close()
        dec.close()


def test_disagg_budget_one_completes_on_prefill_side(tiny, jax_ref):
    pre = _teng(tiny, role="prefill")
    try:
        out = pre.prefill_remote(PROMPTS[0], max_new_tokens=1, timeout=60)
        assert pre.stats()["host_syncs"]["kv_export"] == 0
    finally:
        pre.close()
    assert "kv_handoff" not in out
    assert out["num_generated"] == 1
    assert out["token_ids"] == jax_ref(PROMPTS[0], 1)


def test_disagg_concurrent_installs_queue_for_slots(tiny, jax_ref):
    """More concurrent handoffs than decode slots: installs wait FIFO for
    recycled slots instead of failing."""
    pre, dec = _pair(tiny)
    try:
        handoffs = [pre.prefill_remote(PROMPTS[i % 3], max_new_tokens=8,
                                       timeout=60) for i in range(5)]
        outs = [None] * 5

        def run(i):
            outs[i] = dec.install_remote(handoffs[i], timeout=60)

        ts = [threading.Thread(target=run, args=(i,)) for i in range(5)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in ts)
    finally:
        pre.close()
        dec.close()
    for i in range(5):
        assert outs[i]["token_ids"] == jax_ref(PROMPTS[i % 3], 8), i


def test_disagg_bf16_pages_decode_like_colocated(tiny):
    """bf16 caches hand off bf16 pages bit for bit: the pair's tokens are
    the colocated bf16 engine's."""
    cfg = tllama.tiny_config(max_seq_len=128, dtype=torch.bfloat16)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(3),
                                "cpu")
    engines = [TEngine(cfg, params, device="cpu", role=r, **BASE)
               for r in ("colocated", "prefill", "decode")]
    colo, pre, dec = engines
    try:
        for p in PROMPTS:
            want = colo.generate(p, max_new_tokens=10, timeout=60)
            h = pre.prefill_remote(p, max_new_tokens=10, timeout=60)
            assert h["pages_k"][0].dtype == torch.bfloat16
            assert dec.install_remote(h, timeout=60)["token_ids"] == \
                want["token_ids"]
    finally:
        for e in engines:
            e.close()


@pytest.mark.parametrize("role,entry", [
    ("colocated", "prefill_remote"), ("colocated", "install_async"),
    ("decode", "prefill_remote"), ("prefill", "install_async"),
])
def test_disagg_roles_reject_wrong_entrypoints(tiny, role, entry):
    eng = _teng(tiny, role=role)
    try:
        with pytest.raises(RuntimeError, match=r"requires role="):
            if entry == "prefill_remote":
                eng.prefill_remote(PROMPTS[0])
            else:
                eng.install_async({"page": 16})
    finally:
        eng.close()


def test_disagg_page_size_mismatch_rejected(tiny):
    pre = _teng(tiny, role="prefill", prefix_block=16)
    dec = _teng(tiny, role="decode", prefix_block=8)
    try:
        h = pre.prefill_remote(PROMPTS[1], max_new_tokens=4, timeout=60)
        with pytest.raises(ValueError, match="page size mismatch"):
            dec.install_async(h)
    finally:
        pre.close()
        dec.close()


def test_engine_fault_fails_queued_and_waiting_installs(tiny, jax_ref):
    """A host-side fault in a decode-role tick fails the roster AND the
    installs still queued or waiting for a slot (the port's guard;
    ray_tpu's engine loop has none), and the engine serves on."""
    pre = _teng(tiny, role="prefill")
    dec = _teng(tiny, role="decode", max_batch=1)
    gate = threading.Event()
    real_install, real_decode = dec._install_tick, dec._decode_tick

    def held_install():
        gate.wait(timeout=60)
        real_install()

    def broken_decode():
        raise RuntimeError("tick fault")

    try:
        handoffs = [pre.prefill_remote(PROMPTS[i], max_new_tokens=8,
                                       timeout=60) for i in range(3)]
        dec._install_tick, dec._decode_tick = held_install, broken_decode
        reqs = [dec.install_async(h) for h in handoffs]
        gate.set()
        for r in reqs:
            with pytest.raises(RuntimeError, match="tick fault"):
                r.future.result(timeout=60)
        dec._install_tick, dec._decode_tick = real_install, real_decode
        out = dec.install_remote(handoffs[0], timeout=60)
        assert dec.stats()["installs_waiting"] == 0
    finally:
        pre.close()
        dec.close()
    assert out["token_ids"] == jax_ref(PROMPTS[0], 8)


def test_disagg_engines_close_balanced(tiny, monkeypatch):
    """``ray_tpu``'s case of the same name: under RTPU_DEBUG_RES a full
    prefill -> handoff -> install -> decode round leaves no outstanding
    reservation on either engine, and neither close reports."""
    from ray_tpu_torch.devtools import res_debug

    monkeypatch.setenv("RTPU_DEBUG_RES", "1")
    res_debug.reset()
    try:
        pre, dec = _pair(tiny)
        try:
            h = pre.prefill_remote(PROMPTS[1], max_new_tokens=8, timeout=60)
            assert dec.install_remote(h, timeout=60)["num_generated"] == 8
        finally:
            pre.close()
            dec.close()
        assert res_debug.violations() == []
        assert res_debug.outstanding("kv_spec").get("kv_spec", 0) == 0
        assert res_debug.outstanding("thread") == {}
    finally:
        res_debug.reset()
