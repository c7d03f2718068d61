"""The port's resource witness (``ray_tpu_torch/devtools/res_debug.py``,
``RTPU_DEBUG_RES=1``), case for case with ``tests/test_res_debug.py``.

Each scenario runs on ``ray_tpu``'s witness and on the port's under the
same flag, and the port must give ``ray_tpu``'s ``counts()``,
``outstanding()`` and violation kinds, besides the reference test's own
assertions: the balance registry, the instrumented seams (buffer leases,
KV speculation, tracked threads, QoS tenant lanes, stream cursor slots),
flag-off zero overhead, the flight-recorder payload, the chaos-kill
snapshot, and a speculative engine run balanced at close.
"""

from __future__ import annotations

import importlib
import json
import threading
import time

import numpy as np
import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _res(pkg):
    return _mod(pkg, "devtools.res_debug")


def _both(scenario):
    """Run ``scenario(pkg)`` for ray_tpu and for the port, from a clean
    registry each; the port's result must equal ray_tpu's."""
    out = []
    for pkg in PKGS:
        _res(pkg).reset()
        out.append(scenario(pkg))
        _res(pkg).reset()
    ref, got = out
    assert got == ref, (got, ref)
    return got


def _summary(res):
    return {"counts": res.counts(), "outstanding": res.outstanding(),
            "violations": [v["kind"] for v in res.violations()]}


@pytest.fixture()
def witness_on(monkeypatch):
    monkeypatch.setenv("RTPU_DEBUG_RES", "1")
    for pkg in PKGS:
        _res(pkg).reset()
    yield
    for pkg in PKGS:
        _res(pkg).reset()


@pytest.fixture()
def witness_off(monkeypatch):
    monkeypatch.delenv("RTPU_DEBUG_RES", raising=False)
    for pkg in PKGS:
        _res(pkg).reset()
    yield
    for pkg in PKGS:
        _res(pkg).reset()


def test_leak_kinds_are_ray_tpus():
    assert _res("ray_tpu_torch").LEAK_KINDS == _res("ray_tpu").LEAK_KINDS


# ------------------------------------------------------------- registry


def test_balanced_acquire_release_clean(witness_on):
    def run(pkg):
        res = _res(pkg)
        k = res.note_acquire("lease", key="l1")
        assert res.outstanding() == {"lease": 1}
        res.note_release("lease", k)
        assert res.outstanding() == {}
        assert res.counts()["lease"] == {"acquired": 1, "released": 1,
                                         "outstanding": 0}
        assert res.check_balanced("t", kinds=("lease",))
        return _summary(res)

    assert _both(run)["violations"] == []


def test_deliberate_leak_reported(witness_on, capsys):
    def run(pkg):
        res = _res(pkg)
        res.note_acquire("buffer_lease", key="pin1")
        assert not res.check_balanced("t", kinds=("buffer_lease",))
        v = res.violations()
        assert len(v) == 1 and v[0]["outstanding"] == {"buffer_lease": 1}
        assert "RTPU_DEBUG_RES:" in capsys.readouterr().out
        return _summary(res)

    assert _both(run)["violations"] == ["unbalanced-at-close"]


def test_double_release_is_benign(witness_on):
    def run(pkg):
        res = _res(pkg)
        k = res.note_acquire("lease", key="l1")
        res.note_release("lease", k)
        res.note_release("lease", k)  # idempotent return re-delivery
        return _summary(res)

    got = _both(run)
    assert got["counts"]["lease"]["released"] == 1
    assert got["violations"] == []


def test_owner_scoping(witness_on):
    def run(pkg):
        res = _res(pkg)
        a, b = object(), object()
        res.note_acquire("kv_spec", key=("a", 1), owner=a)
        res.note_acquire("kv_spec", key=("b", 1), owner=b)
        assert res.outstanding("kv_spec", owner=a) == {"kv_spec": 1}
        res.note_release("kv_spec", ("a", 1))
        return (res.check_balanced("t", kinds=("kv_spec",), owner=a),
                res.check_balanced("t", kinds=("kv_spec",), owner=b),
                _summary(res))

    ok_a, ok_b, _ = _both(run)
    assert ok_a and not ok_b


# ----------------------------------------------------- flag-off overhead


def test_flag_off_everything_unwrapped(witness_off):
    def run(pkg):
        res = _res(pkg)

        def rel():
            pass

        assert res.wrap_release("buffer_lease", rel) is rel
        t = threading.Thread(target=lambda: None, daemon=True)
        assert res.track_thread(t) is t
        assert "run" not in t.__dict__
        assert res.note_acquire("lease", key="x") == "x"
        res.note_release("lease", "x")
        res.note_event("store_seal")
        assert res.check_balanced("t", kinds=("lease",))
        return (_summary(res), res.counters())

    got, counters = _both(run)
    assert got["outstanding"] == {} and counters == {}


def test_flag_off_buffer_lease_untouched(witness_off):
    def run(pkg):
        BufferLease = _mod(pkg, "cluster.protocol").BufferLease
        calls = []
        BufferLease("v", lambda: calls.append(1)).release()
        return calls, _summary(_res(pkg))

    calls, got = _both(run)
    assert calls == [1] and got["outstanding"] == {}


# --------------------------------------------------- instrumented seams


def test_buffer_lease_balance_and_leak(witness_on):
    def run(pkg):
        res = _res(pkg)
        BufferLease = _mod(pkg, "cluster.protocol").BufferLease
        calls = []
        lease = BufferLease("v", lambda: calls.append(1))
        assert res.outstanding() == {"buffer_lease": 1}
        lease.release()
        lease.release()  # guarded upstream AND in the witness
        leaked = BufferLease("w", lambda: None)
        snap = (calls, _summary(res), res.dump_payload()["leaked"])
        leaked.release()
        return snap

    calls, got, leaked = _both(run)
    assert calls == [1] and got["outstanding"] == {"buffer_lease": 1}
    assert leaked == 1


def test_kv_speculation_balance(witness_on):
    def run(pkg):
        res = _res(pkg)
        kv = _mod(pkg, "serve.engine.kv_manager").KVCacheManager(
            2, 64, block_size=16)
        slot, _ = kv.acquire([1, 2, 3, 4], fit=None)
        kv.begin_speculation(slot, 4)
        assert res.outstanding() == {"kv_spec": 1}
        kv.commit_speculation(slot, 2)
        kv.begin_speculation(slot, 4)
        kv.release(slot)  # the device-failure path: dies with the slot
        assert res.check_balanced("kv", kinds=("kv_spec",), owner=kv)
        return _summary(res)

    got = _both(run)
    assert got["counts"]["kv_spec"] == {"acquired": 2, "released": 2,
                                        "outstanding": 0}


def test_tracked_thread_outstanding_until_run_returns(witness_on):
    def run(pkg):
        res = _res(pkg)
        gate = threading.Event()
        t = res.track_thread(threading.Thread(target=gate.wait,
                                              daemon=True))
        t.start()
        assert res.outstanding() == {"thread": 1}
        gate.set()
        t.join(timeout=5.0)
        deadline = time.monotonic() + 2.0
        while res.outstanding() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert res.check_balanced("t", kinds=("thread",))
        return _summary(res)

    assert _both(run)["outstanding"] == {}


# ---------------------------------------------- flight-recorder payload


def test_dump_payload_rides_flight_recorder(witness_on):
    def run(pkg):
        res = _res(pkg)
        fr = _mod(pkg, "util.flight_recorder")
        res.note_acquire("lease", key="leaky")
        res.note_event("store_seal", 3)
        rd = fr.dump_payload()["res_debug"]
        res.note_release("lease", "leaky")
        return rd, fr.dump_payload()["res_debug"]["leaked"]

    rd, after = _both(run)
    assert rd["outstanding"] == {"lease": 1} and rd["leaked"] == 1
    assert rd["counters"] == {"store_seal": 3} and rd["violations"] == 0
    assert after == 0


def test_dump_payload_absent_when_off(witness_off):
    for pkg in PKGS:
        assert "res_debug" not in _mod(pkg,
                                       "util.flight_recorder").dump_payload()


def test_chaos_kill_snapshot_carries_res_debug(witness_on, tmp_path,
                                               monkeypatch):
    """The pre-SIGKILL flight dump carries the balance snapshot."""

    def run(pkg):
        cfg = _mod(pkg, "core.config").GLOBAL_CONFIG
        chaos = _mod(pkg, "devtools.chaos")
        res = _res(pkg)
        killed = []
        monkeypatch.setattr(chaos, "_kill_self", lambda: killed.append(1))
        out = tmp_path / pkg
        out.mkdir()
        old_dir = cfg.get("flight_recorder_dump_dir")
        old_plan = cfg.get("chaos_plan")
        cfg.set("flight_recorder_dump_dir", str(out))
        cfg.set("chaos_plan", "kill:method=port_res_doomed_rpc:nth=1")
        try:
            res.note_acquire("lease", key="held-at-death")
            verdict = chaos.apply("head", "port_res_doomed_rpc", "request")
            assert killed and verdict == chaos.DROP
            files = list(out.glob("flight-*.json"))
            assert files, "chaos kill produced no flight dump"
            rd = json.loads(files[0].read_text())["res_debug"]
            return rd["outstanding"], rd["leaked"]
        finally:
            cfg.set("chaos_plan", old_plan)
            cfg.set("flight_recorder_dump_dir", old_dir)

    assert _both(run) == ({"lease": 1}, 1)


# ------------------------------------------- serving state (qos/streams)


def test_qos_tenant_churn_reaped_and_balanced(witness_on):
    def run(pkg):
        qos = _mod(pkg, "serve._private.qos")
        q = qos.WFQQueue(idle_ttl=5.0)
        q.configure("vip", qos.TenantConfig(weight=2.0), 0.0)
        for i in range(20):
            name = f"ephemeral-{i}"
            tk = q.submit(name, 1.0, float(i))
            assert q.head(float(i)) is tk
            q.admit(tk, float(i))
            q.release(name)
        assert q.head(100.0) is None  # nothing queued; reap runs
        return sorted(q._tenants), _summary(_res(pkg))

    tenants, got = _both(run)
    assert tenants == ["vip"]
    assert got["outstanding"] == {} and got["violations"] == []
    assert got["counts"]["qos_tenant"]["acquired"] == 20


def test_qos_lane_with_work_never_reaped(witness_on):
    def run(pkg):
        q = _mod(pkg, "serve._private.qos").WFQQueue(idle_ttl=1.0)
        tk = q.submit("busy", 1.0, 0.0)
        reaped = [q.reap_idle(1000.0)]         # queued: immune
        q.admit(tk, 1000.0)
        q._tenants["busy"].last_active = 0.0
        reaped.append(q.reap_idle(2000.0))     # inflight: immune
        q.release("busy")
        reaped.append(q.reap_idle(5000.0))     # quiet past TTL: reaped
        return reaped, _summary(_res(pkg))

    reaped, got = _both(run)
    assert reaped == [0, 0, 1] and got["outstanding"] == {}


def test_qos_configure_pins_lazy_lane_and_settles_ledger(witness_on):
    def run(pkg):
        qos = _mod(pkg, "serve._private.qos")
        res = _res(pkg)
        q = qos.WFQQueue(idle_ttl=1.0)
        q.tenant("t", 0.0)
        assert res.outstanding("qos_tenant") == {"qos_tenant": 1}
        q.configure("t", qos.TenantConfig(weight=2.0), 0.0)
        q.reap_idle(100.0)
        return "t" in q._tenants, _summary(res)

    pinned, got = _both(run)
    assert pinned and got["outstanding"] == {}


def test_qos_close_settles_ledger(witness_on):
    def run(pkg):
        q = _mod(pkg, "serve._private.qos").WFQQueue()
        q.tenant("a", 0.0)
        q.tenant("b", 0.0)
        assert _res(pkg).outstanding("qos_tenant") == {"qos_tenant": 2}
        q.close()
        return _summary(_res(pkg))

    assert _both(run)["outstanding"] == {}


class _Streamer:
    def gen(self, n):
        for i in range(n):
            yield i

    def boom(self):
        yield 0
        raise ValueError("boom")


def test_stream_cancel_loop_balanced(witness_on):
    def run(pkg):
        rep = _mod(pkg, "serve._private.replica").ReplicaActor(
            _Streamer, (), {})
        for _ in range(3):  # completion path
            sid, items, done = rep.handle_request_streaming("gen", (4,), {})
            while not done:
                more, done = rep.next_chunks(sid, wait_s=5.0)
                items += more
            assert items == [0, 1, 2, 3]
        for _ in range(3):  # cancel path: the consumer walks away
            sid, _, done = rep.handle_request_streaming(
                "gen", (100000,), {}, first_wait_s=0)
            assert rep.cancel_stream(sid) or done
        sid, items, done = rep.handle_request_streaming(
            "boom", (), {}, first_wait_s=0)
        with pytest.raises(ValueError, match="boom"):
            while not done:
                more, done = rep.next_chunks(sid, wait_s=5.0)
        assert rep._streams == {} and rep._stream_errors == {}
        return _summary(_res(pkg))

    got = _both(run)
    assert got["counts"]["serve_stream"] == {"acquired": 7, "released": 7,
                                             "outstanding": 0}
    assert got["violations"] == []


def test_stream_ttl_reaper_settles_ledger(witness_on):
    def run(pkg):
        rep = _mod(pkg, "serve._private.replica").ReplicaActor(
            _Streamer, (), {})
        sid, _, _ = rep.handle_request_streaming(
            "gen", (100000,), {}, first_wait_s=0)
        assert _res(pkg).outstanding("serve_stream") == {"serve_stream": 1}
        rep._streams[sid][2] -= 10_000  # last poll "long ago"
        rep._reap_stale_streams()
        assert sid not in rep._streams
        return _summary(_res(pkg))

    assert _both(run)["outstanding"] == {}


# --------------------------------------------------- engine end-to-end


def test_engine_spec_run_balanced_and_close_clean(witness_on):
    """The same speculative request on ray_tpu's engine and the port's,
    from one seeded parameter tree: equal tokens, equal kv_spec counts,
    balanced at close with no violation."""
    import jax

    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.models import llama as tllama

    jcfg = jllama.tiny_config(max_seq_len=64)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tllama.tiny_config(max_seq_len=64)
    tparams = tllama.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(jparams)), tcfg, "cpu")
    kw = dict(max_batch=2, max_len=64, prompt_buckets=[8, 16],
              decode_chunk=4, spec_draft_len=4, spec_chunk=2,
              spec_ngram_max=4)

    def run(pkg):
        LLMEngine = _mod(pkg, "serve.llm").LLMEngine
        eng = (LLMEngine(jcfg, jparams, **kw) if pkg == "ray_tpu"
               else LLMEngine(tcfg, tparams, device="cpu", **kw))
        try:
            out = eng.generate([5, 6, 5, 6, 5, 6, 5], max_new_tokens=8,
                               timeout=120.0)
        finally:
            eng.close()
        res = _res(pkg)
        return (out["token_ids"], res.counts().get("kv_spec"),
                res.outstanding("kv_spec"),
                [v["kind"] for v in res.violations()])

    tokens, spec, open_spec, bad = _both(run)
    assert len(tokens) == 8 and spec["acquired"] >= 1
    assert open_spec == {} and bad == []
