"""The port's fleet KV page tier (``serve/engine/kv_fleet.py`` and the
engine's spill/pull paths) against ``ray_tpu`` on the CPU.

Store tier: page object ids byte-equal to ``ray_tpu``'s ``ObjectID``
binary, the namespace, the pack/unpack codec (bf16 pages bit for bit,
corruption read as a miss) and the LRU cap. Engine tier, the store-free
cases of ``tests/test_kv_fleet.py``: evict -> spill -> pull on a fresh
engine gives ``ray_tpu``'s greedy tokens on the same weights; corrupted
payloads and chain mismatches are refused and recomputed; the min-blocks
gate; the fleet-off engine is the engine without the knob; snapshot and
crossover stats; a preempted session resumed on another engine through
the tier. Cluster tier, on the port's cluster runtime: a page put by one
worker process is got by another under the same ``page_object_id``,
``resolve_store`` picks ``ClusterKVPageStore`` under a runtime, and the
counterpart of ``test_fleet_pages_survive_replica_sigkill``. Left out: the
``RTPU_DEBUG_RES`` balance case (the witness is not ported) and the
router's fleet term.
"""

import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.core.ids import ObjectID
from ray_tpu.models import llama as jllama
from ray_tpu.serve.engine import kv_fleet as jfleet
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.engine import kv_fleet
from ray_tpu_torch.serve.engine.kv_manager import chain_hashes
from ray_tpu_torch.serve.llm import LLMEngine as TEngine

BLOCK = 8
BASE = dict(max_batch=1, max_len=96, prompt_buckets=[8, 16, 32],
            decode_chunk=4, seed=0, prefix_block=BLOCK)
P1 = list(range(1, 33))      # 32 tokens = 4 complete blocks at BLOCK=8
P2 = list(range(100, 132))   # disjoint: admitting it evicts P1's slot


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tllama.tiny_config(max_seq_len=128)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """ray_tpu's fleet-off engine: greedy tokens by (prompt, budget)."""
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


def _fleet_engine(tiny, store, gate=0, **kw):
    return _engine(tiny, kv_fleet_min_prefix_blocks=gate,
                   kv_fleet_store=store, **kw)


def _wait_objects(store, n, timeout=30.0):
    """Packing and puts run on the spill worker: poll for n objects."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if store.stats()["objects"] >= n:
            return
        time.sleep(0.01)
    raise AssertionError(f"store never reached {n} objects: "
                         f"{store.stats()}")


def _spill_from_fresh_engine(tiny, store, **kw):
    """P1 then P2 through a one-slot fleet engine: admitting P2 evicts
    P1's resident prefix and spills its complete blocks. Returns (engine,
    P1's tokens)."""
    eng = _fleet_engine(tiny, store, **kw)
    ref = eng.generate(P1, max_new_tokens=8, timeout=60)
    eng.generate(P2, max_new_tokens=8, timeout=60)
    _wait_objects(store, 4)  # P1's 4 complete prompt blocks
    return eng, ref


# ------------------------------------------------------------ store tier


@pytest.mark.parametrize("chain_hash", [0, 12345, -7, 2 ** 63 + 5,
                                        -(2 ** 63) + 17])
def test_page_object_id_equals_ray_tpu_object_id(chain_hash):
    ns = b"n" * 20
    got = kv_fleet.page_object_id(ns, chain_hash)
    want = jfleet.page_object_id(ns, chain_hash)
    assert isinstance(want, ObjectID)
    assert got == want.binary()
    assert len(got) == 28


def test_page_object_id_deterministic_and_namespaced():
    ns_a, ns_b = b"a" * 20, b"b" * 20
    oid = kv_fleet.page_object_id(ns_a, 12345)
    assert oid == kv_fleet.page_object_id(ns_a, 12345)
    assert oid != kv_fleet.page_object_id(ns_a, 12346)
    # The same chain hash under another model fingerprint is another
    # object: cross-model KV reuse is unreachable.
    assert oid != kv_fleet.page_object_id(ns_b, 12345)


def test_fleet_namespace_tracks_model_identity():
    cfg = tllama.tiny_config(max_seq_len=96)
    base = kv_fleet.fleet_namespace(cfg, 8, None, 0)
    assert len(base) == 20
    assert base == kv_fleet.fleet_namespace(cfg, 8, None, 0)
    assert base != kv_fleet.fleet_namespace(cfg, 16, None, 0)    # block
    assert base != kv_fleet.fleet_namespace(cfg, 8, "int8", 0)   # quantize
    assert base != kv_fleet.fleet_namespace(cfg, 8, None, 1)     # seed
    bf16 = tllama.tiny_config(max_seq_len=96, dtype=torch.bfloat16)
    assert base != kv_fleet.fleet_namespace(bf16, 8, None, 0)    # dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_unpack_roundtrip_and_corruption_rejected(dtype):
    """bf16 pages come back bf16 bit for bit (stored as uint16 bits, the
    dtype in the frame); one flipped payload byte, a short frame or junk
    read as None, like a store miss."""
    k = (torch.arange(2 * 4 * 8 * 16, dtype=torch.float32)
         .reshape(2, 4, 8, 16) * 0.37 - 50.0).to(dtype)
    v = k * 2.0
    crc = kv_fleet.page_crc(k, v)
    raw = kv_fleet.pack_page(list(range(8)), [11, 22], k, v, crc)
    page = kv_fleet.unpack_page(raw)
    assert page is not None
    assert page["tokens"] == list(range(8))
    assert page["chain"] == [11, 22]
    assert page["crc"] == crc
    for name, want in (("k_page", k), ("v_page", v)):
        assert page[name].dtype == dtype
        assert torch.equal(page[name], want)
        assert kv_fleet.page_bytes(page[name]) == kv_fleet.page_bytes(want)
    bad = bytearray(raw)
    bad[-9] ^= 0xFF
    assert kv_fleet.unpack_page(bytes(bad)) is None
    assert kv_fleet.unpack_page(b"junk") is None
    assert kv_fleet.unpack_page(raw[:40]) is None


def test_page_crc_matches_ray_tpu_on_f32_pages():
    """The CRC is ray_tpu's (crc32 of k's bytes ^ crc32 of v's) on the
    same f32 pages."""
    import zlib

    rng = np.random.RandomState(0)
    k, v = (rng.randn(2, 4, 8, 16).astype(np.float32) for _ in range(2))
    want = zlib.crc32(k.tobytes()) ^ zlib.crc32(v.tobytes())
    assert kv_fleet.page_crc(torch.from_numpy(k),
                             torch.from_numpy(v)) == want


def test_local_store_lru_byte_cap():
    store = kv_fleet.LocalKVPageStore(capacity_bytes=3000)
    ns = b"n" * 20
    oids = [kv_fleet.page_object_id(ns, i) for i in range(4)]
    for oid in oids:
        assert store.put(oid, b"x" * 1000)
    assert not store.put(oids[-1], b"dup")  # dedupe: a second put no-ops
    st = store.stats()
    assert st["bytes"] <= 3000 and st["evictions"] >= 1
    assert not store.contains(oids[0])  # oldest evicted first
    assert store.contains(oids[-1])
    assert store.get(oids[-1]) == b"x" * 1000
    assert store.delete(oids[-1]) and not store.contains(oids[-1])


def test_resolve_store_and_defaults():
    explicit = kv_fleet.LocalKVPageStore(capacity_bytes=10)
    assert kv_fleet.resolve_store(explicit) is explicit
    assert kv_fleet.resolve_store() is kv_fleet.local_store()
    assert kv_fleet.local_store().capacity_bytes == 256 << 20
    from ray_tpu.core.config import GLOBAL_CONFIG as cfg

    assert kv_fleet.LOCAL_BYTES == cfg.serve_kv_fleet_local_bytes
    assert kv_fleet.MIN_PREFIX_BLOCKS == \
        cfg.serve_kv_fleet_min_prefix_blocks
    assert kv_fleet.SNAPSHOT_FLEET_HASHES == cfg.serve_snapshot_fleet_hashes
    assert kv_fleet.SNAPSHOT_PREFIX_HASHES == \
        cfg.serve_snapshot_prefix_hashes


# ------------------------------------------------------------ engine tier


def test_evict_spill_reinstall_token_identity(tiny, jax_ref):
    """Blocks evicted from engine A spill into the shared store; a FRESH
    engine B pulls them back through install_page + the chain check and
    gives ray_tpu's tokens (and A's)."""
    store = kv_fleet.LocalKVPageStore(64 << 20)
    eng_a, ref = _spill_from_fresh_engine(tiny, store)
    try:
        st_a = eng_a.stats()
        assert st_a["kv_fleet_spilled_blocks"] >= 4
        # One counted sync a spilled batch.
        assert st_a["host_syncs"]["kv_spill"] >= 1
        eng_b = _fleet_engine(tiny, store)
        try:
            out = eng_b.generate(P1, max_new_tokens=8, timeout=60)
            st = eng_b.stats()
            assert eng_b.kv.free_slots() == eng_b.max_batch
        finally:
            eng_b.close()
    finally:
        eng_a.close()
    assert out["token_ids"] == ref["token_ids"] == jax_ref(P1, 8)
    assert st["kv_fleet_hits"] == 1
    # Reuse stops at len(prompt)-1 like the local cache: 3 of the 4
    # spilled blocks install as one run, the last token prefills.
    assert st["kv_fleet_pulled_blocks"] == 3
    assert st["kv_fleet_tokens_reused"] == 3 * BLOCK
    assert out["cached_prefix_len"] == 3 * BLOCK
    assert st["dispatches"]["install_page"] == 1


def test_bf16_fleet_pull_matches_fleet_off(tiny):
    """bf16 pages through the frames and back: the pulling engine's
    tokens are the fleet-off bf16 engine's."""
    cfg = tllama.tiny_config(max_seq_len=128, dtype=torch.bfloat16)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(5),
                                "cpu")

    def make(**kw):
        return TEngine(cfg, params, device="cpu", **dict(BASE, **kw))

    off = make()
    try:
        want = off.generate(P1, max_new_tokens=8, timeout=60)["token_ids"]
    finally:
        off.close()
    store = kv_fleet.LocalKVPageStore(64 << 20)
    a = make(kv_fleet_min_prefix_blocks=0, kv_fleet_store=store)
    try:
        a.generate(P1, max_new_tokens=8, timeout=60)
        a.generate(P2, max_new_tokens=8, timeout=60)
        _wait_objects(store, 4)
    finally:
        a.close()
    b = make(kv_fleet_min_prefix_blocks=0, kv_fleet_store=store)
    try:
        out = b.generate(P1, max_new_tokens=8, timeout=60)
        st = b.stats()
    finally:
        b.close()
    assert out["token_ids"] == want
    assert st["kv_fleet_pulled_blocks"] == 3 and st["kv_fleet_rejects"] == 0


def _corrupt_all(store):
    with store._lock:
        for key, raw in list(store._objs.items()):
            bad = bytearray(raw)
            bad[-9] ^= 0xFF
            store._objs[key] = bytes(bad)


def test_corrupted_payload_rejected_recomputes(tiny, jax_ref):
    """Bit rot in the store (CRC mismatch) reads as a miss: the output is
    recomputed, token-identical, and the slot is unharmed."""
    store = kv_fleet.LocalKVPageStore(64 << 20)
    eng_a, _ref = _spill_from_fresh_engine(tiny, store)
    eng_a.close()
    _corrupt_all(store)
    eng_b = _fleet_engine(tiny, store)
    try:
        out = eng_b.generate(P1, max_new_tokens=8, timeout=60)
        st = eng_b.stats()
        assert eng_b.kv.free_slots() == eng_b.max_batch
    finally:
        eng_b.close()
    assert out["token_ids"] == jax_ref(P1, 8)
    assert st["kv_fleet_hits"] == 0
    assert st["kv_fleet_rejects"] >= 1


def test_chain_mismatch_rejected_recomputes(tiny, jax_ref):
    """A payload with intact bytes whose chain disagrees with the prompt's
    (a collision, a wrong-prefix object) is refused by the verify seam."""
    store = kv_fleet.LocalKVPageStore(64 << 20)
    eng_a, _ref = _spill_from_fresh_engine(tiny, store)
    ns = eng_a._fleet_ns
    eng_a.close()
    assert ns == kv_fleet.fleet_namespace(tiny[2], BLOCK, None, 0)
    oid = kv_fleet.page_object_id(ns, chain_hashes(P1, BLOCK)[0])
    page = kv_fleet.unpack_page(store.get(oid))
    assert page is not None
    store.delete(oid)
    store.put(oid, kv_fleet.pack_page(page["tokens"], [123456789],
                                      page["k_page"], page["v_page"],
                                      page["crc"]))
    eng_b = _fleet_engine(tiny, store)
    try:
        out = eng_b.generate(P1, max_new_tokens=8, timeout=60)
        st = eng_b.stats()
        assert eng_b.kv.free_slots() == eng_b.max_batch
    finally:
        eng_b.close()
    assert out["token_ids"] == jax_ref(P1, 8)
    assert st["kv_fleet_hits"] == 0 and st["kv_fleet_rejects"] >= 1


@pytest.mark.parametrize("gate,hits", [(4, 0), (3, 1), ("auto", 1)])
def test_min_prefix_blocks_gate(tiny, jax_ref, gate, hits):
    """Only 3 blocks are pullable (the len-1 stop): a floor of 4 vetoes,
    3 pulls, and "auto" pulls single blocks until the recompute side has
    a sample."""
    store = kv_fleet.LocalKVPageStore(64 << 20)
    eng_a, _ref = _spill_from_fresh_engine(tiny, store)
    eng_a.close()
    eng_b = _fleet_engine(tiny, store, gate=gate)
    try:
        out = eng_b.generate(P1, max_new_tokens=8, timeout=60)
        st = eng_b.stats()
    finally:
        eng_b.close()
    assert out["token_ids"] == jax_ref(P1, 8)
    assert st["kv_fleet_hits"] == hits


@pytest.mark.parametrize("knobs", [{}, {"kv_fleet_min_prefix_blocks": -1},
                                   {"kv_fleet_store": object()}])
def test_fleet_off_is_the_engine_without_the_knob(tiny, knobs):
    """The default (-1, and a store without a gate, as in ray_tpu) builds
    nothing new: no transfer programs, no spill hook or thread, no padded
    cache, no fleet keys in stats or the snapshot."""
    eng = _engine(tiny, **knobs)
    plain = _engine(tiny)
    try:
        assert eng._fleet is None
        assert eng.kv.spill_hook is None
        assert eng.loop.kv_page == 0
        assert not hasattr(eng, "_spill_thread")
        assert eng.cache["k"].shape == plain.cache["k"].shape
        st = eng.stats()
        assert not any(k.startswith("kv_fleet") for k in st)
        assert st["host_syncs"] == {"prefill": 0, "decode": 0}
        assert set(st["dispatches"]) == {"prefill", "decode", "verify"}
        snap = eng.load_snapshot()
        assert "fleet_kv_blocks" not in snap
        assert "fleet_kv_hashes" not in snap
        assert set(snap) == set(plain.load_snapshot())
    finally:
        eng.close()
        plain.close()


def test_fleet_snapshot_and_crossover_stat(tiny):
    store = kv_fleet.LocalKVPageStore(64 << 20)
    eng_a, _ref = _spill_from_fresh_engine(tiny, store)
    try:
        snap = eng_a.load_snapshot()
        st = eng_a.stats()
    finally:
        eng_a.close()
    assert snap["fleet_kv_blocks"] >= 4
    assert len(snap["fleet_kv_hashes"]) >= 4
    # The pull side is measured at engine start; the key is always there
    # (None until the recompute side has its first sample after the
    # engine's first admission).
    assert "kv_pull_vs_recompute_crossover_blocks" in st
    assert st["kv_fleet_pull_ms_per_page"] > 0.0
    assert st["kv_fleet_prefill_ms_per_block"] > 0.0
    co = st["kv_pull_vs_recompute_crossover_blocks"]
    assert co is None or co == -1 or co >= 1
    assert st["kv_fleet_store"]["objects"] >= 4


def test_eviction_under_preemption_cross_replica_resume(tiny, jax_ref):
    """A preempted session's parked KV is evicted under pressure, spills
    into the shared store, and the session resumes token-identically on
    ANOTHER engine that pulls it back: park/resume composed with the
    spill tier. Engine A never resumes the victim."""
    store = kv_fleet.LocalKVPageStore(64 << 20)
    eng_a = _fleet_engine(tiny, store)
    eng_a._resume_tick = lambda: None
    try:
        lo = eng_a._make_request(P1, 24, None, stream=True, priority=0)
        eng_a._queue.put(lo)
        kind, val = lo.stream_queue.get(timeout=60)
        assert kind not in ("done", "error"), (kind, val)
        hi = eng_a._make_request(list(range(200, 216)), 8, None,
                                 priority=5)
        eng_a._queue.put(hi)
        deadline = time.time() + 60
        while not eng_a._parked:
            assert time.time() < deadline, "lo never parked"
            time.sleep(0.001)
        hi.future.result(timeout=60)
        # Pressure on A: a disjoint admission evicts the parked session's
        # resident rows, whose complete blocks spill.
        eng_a.generate(P2, max_new_tokens=8, timeout=60)
        _wait_objects(store, 4)
        assert eng_a._preempts >= 1
        assert eng_a._parked and eng_a._parked[0] is lo
        prefix = list(lo.prompt_ids) + list(lo.generated)
        remaining = lo.remaining()
        assert lo.generated and remaining > 0
    finally:
        eng_a.close()
    eng_b = _fleet_engine(tiny, store)
    try:
        out = eng_b.generate(prefix, max_new_tokens=remaining, timeout=60)
        st = eng_b.stats()
    finally:
        eng_b.close()
    assert list(lo.generated) + out["token_ids"] == jax_ref(P1, 24)
    assert st["kv_fleet_hits"] >= 1
    assert st["kv_fleet_pulled_blocks"] >= 1


# ----------------------------------------------------------- cluster tier


@pytest.fixture(scope="module")
def fleet_cluster():
    """The port's cluster runtime (head, node manager, worker processes
    over its shm store), for the ``ClusterKVPageStore`` cases."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

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


def test_cluster_store_page_crosses_worker_processes(fleet_cluster):
    """A bf16 page put by one worker process is got by another under the
    same ``page_object_id`` (a local-arena hit: one node), bit for bit;
    the driver sees it too, and a delete removes it."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class Holder:
        def put(self, oid, block, chain, k, v):
            import os

            from ray_tpu_torch.core.runtime_context import get_runtime

            store = kv_fleet.ClusterKVPageStore(get_runtime())
            payload = kv_fleet.pack_page(block, chain, k, v,
                                         kv_fleet.page_crc(k, v))
            return os.getpid(), store.put(oid, payload), store.put(
                oid, payload)

        def get(self, oid):
            import os

            from ray_tpu_torch.core.runtime_context import get_runtime

            store = kv_fleet.ClusterKVPageStore(get_runtime())
            raw = store.get(oid)
            return os.getpid(), kv_fleet.unpack_page(raw)

    g = torch.Generator().manual_seed(5)
    k = torch.randn(2, 2, BLOCK, 16, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 2, BLOCK, 16, generator=g).to(torch.bfloat16)
    block, chain = list(range(BLOCK)), chain_hashes(list(range(BLOCK)),
                                                    BLOCK)
    ns = kv_fleet.fleet_namespace(tllama.tiny_config(max_seq_len=128),
                                  BLOCK, None, 0)
    oid = kv_fleet.page_object_id(ns, chain[-1])
    a, b = Holder.remote(), Holder.remote()
    try:
        pid_a, first, again = ray_tpu_torch.get(
            a.put.remote(oid, block, chain, k, v), timeout=60)
        assert (first, again) == (True, False)  # the second put dedups
        pid_b, page = ray_tpu_torch.get(b.get.remote(oid), timeout=60)
    finally:
        for h in (a, b):
            ray_tpu_torch.kill(h)
    assert pid_a != pid_b
    assert page["k_page"].dtype == torch.bfloat16
    for got, want in ((page["k_page"], k), (page["v_page"], v)):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert list(page["tokens"]) == block and list(page["chain"]) == chain
    store = kv_fleet.ClusterKVPageStore(fleet_cluster)
    assert store.contains(oid) and store.stats()["objects"] >= 1
    assert store.delete(oid) and not store.contains(oid)
    assert store.get(oid) is None


def test_resolve_store_picks_the_cluster_store(fleet_cluster):
    """Under a cluster runtime an engine's default page tier is the
    cluster store, in the driver and in a worker process."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def kind():
        return type(kv_fleet.resolve_store()).__name__

    assert isinstance(kv_fleet.resolve_store(),
                      kv_fleet.ClusterKVPageStore)
    explicit = kv_fleet.LocalKVPageStore()
    assert kv_fleet.resolve_store(explicit) is explicit
    assert ray_tpu_torch.get(kind.remote(), timeout=60) == \
        "ClusterKVPageStore"


def test_fleet_pages_survive_replica_sigkill(fleet_cluster, tiny, jax_ref):
    """Churn: a killed replica's cache dies with it, but its SPILLED pages
    live in the node's shm arena — still pullable, and the replies stay
    ``ray_tpu``'s tokens through the restart."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.serve.llm import build_llm_deployment

    ek = dict(cfg=tiny[2], params=tiny[3], device="cpu",
              kv_fleet_min_prefix_blocks=0, **BASE)
    h = serve.run(build_llm_deployment(name="kvfleet", num_replicas=2,
                                       engine_kwargs=ek))
    try:
        for p in (P1, P2):
            out = h.remote({"prompt_ids": p,
                            "max_new_tokens": 8}).result(timeout=180)
            assert out["token_ids"] == jax_ref(p, 8)
        # Single-slot engines evict on each new prompt: one more round of
        # P2/P1 makes every replica that held P1 spill it.
        for p in (P2, P1, P2):
            out = h.remote({"prompt_ids": p,
                            "max_new_tokens": 8}).result(timeout=180)
            assert out["token_ids"] == jax_ref(p, 8)

        ns = kv_fleet.fleet_namespace(tiny[2], BLOCK, None, 0)
        store = kv_fleet.ClusterKVPageStore(fleet_cluster)
        want = chain_hashes(P1, BLOCK)

        def pullable():
            return all(kv_fleet.unpack_page(
                store.get(kv_fleet.page_object_id(ns, hh)) or b"")
                is not None for hh in want[:3])

        deadline = time.time() + 60
        while time.time() < deadline and not pullable():
            time.sleep(0.2)
        assert pullable(), "P1's spilled pages never landed in the store"

        controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
        replicas = ray_tpu_torch.get(
            controller.get_replicas.remote("kvfleet"), timeout=30)
        assert len(replicas) == 2
        ray_tpu_torch.kill(replicas[0])
        # The dead replica's pages REMAIN pullable from the node store.
        assert pullable()

        # Requests racing the controller's death report may land on the
        # corpse — that window is the router's to close, not this tier's,
        # so a transient ActorDiedError retries until the set converges.
        def gen(p, deadline):
            while True:
                try:
                    return h.remote({"prompt_ids": p, "max_new_tokens": 8}
                                    ).result(timeout=180)
                except ActorDiedError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.5)

        deadline = time.time() + 120
        for _trip in range(3):
            for p in (P1, P2):
                assert gen(p, deadline)["token_ids"] == jax_ref(p, 8)
    finally:
        serve.delete("kvfleet")
