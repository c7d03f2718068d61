"""The port's RPC-contract witness (``ray_tpu_torch/devtools/rpc_debug.py``,
``RTPU_DEBUG_RPC=1``), case for case with ``tests/test_rpc_debug.py``.

Each scenario runs over a real ``RpcServer``/``RpcClient`` pair of
``ray_tpu`` and of the port under the same flag: the port must give
``ray_tpu``'s replies, duplicate-audit counts and violation kinds
(classification holes, the at-most-once audit, the outbox ordering
witness, the flag-off contract). The classification sets themselves are
``ray_tpu``'s, plus the port's own read-only ``spawn_stats``.
"""

from __future__ import annotations

import importlib
import pickle

import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _rpc(pkg):
    return _mod(pkg, "devtools.rpc_debug")


def _proto(pkg):
    return _mod(pkg, "cluster.protocol")


def _both(scenario):
    out = []
    for pkg in PKGS:
        _rpc(pkg).reset()
        out.append(scenario(pkg))
        _rpc(pkg).reset()
    ref, got = out
    assert got == ref, (got, ref)
    return got


def _kinds(pkg):
    return [v["kind"] for v in _rpc(pkg).violations()]


@pytest.fixture
def witness(monkeypatch):
    monkeypatch.setenv("RTPU_DEBUG_RPC", "1")
    yield
    for pkg in PKGS:
        _rpc(pkg).reset()


class _Handler:
    """Handlers named after real classified methods: reserve_bundle
    (idempotent, memoized), new_job_id (acked-retry), ping (read-only),
    kv_put (declared idempotent; broken on request to prove the audit
    refuses it)."""

    chaos_role = "node"
    extra_retry_safe_rpcs = frozenset({"echo_local"})
    extra_idempotent_rpcs = frozenset({"fetch_chunk_local"})

    def __init__(self, pkg, break_kv_put: bool = False):
        self.pkg = pkg
        self.break_kv_put = break_kv_put
        self.bundles = {}
        self.job_counter = 0
        self.kv = {}
        self.releases = 0

    def rpc_ping(self, conn):
        return "pong"

    def rpc_echo_local(self, conn, x):
        return x

    def rpc_reserve_bundle(self, conn, pg_id, idx, bundle):
        if (pg_id, idx) in self.bundles:
            return True
        self.bundles[(pg_id, idx)] = dict(bundle)
        return True

    def rpc_new_job_id(self, conn):
        self.job_counter += 1
        return self.job_counter

    def rpc_kv_put(self, conn, ns, key, value, overwrite=True):
        if self.break_kv_put:
            self.job_counter += 1
            return self.job_counter
        self.kv[(ns, key)] = value
        return True

    def rpc_fetch_chunk_local(self, conn, offset, chunk):
        view = memoryview(b"0123456789abcdef")[offset:offset + chunk]

        def release():
            self.releases += 1

        return _proto(self.pkg).BufferLease(
            (16, pickle.PickleBuffer(view)), release)

    def rpc_totally_new_thing(self, conn):
        return 1


class _ChannelHandler:
    """Channel-negotiation handlers shaped like the head's."""

    chaos_role = "node"

    def __init__(self):
        self.channels = {}

    def rpc_channel_register(self, conn, channel_id, addr, owner="",
                             node_id=""):
        self.channels[channel_id] = {"addr": addr, "owner": owner,
                                     "node_id": node_id, "alive": True}
        return True

    def rpc_channel_lookup(self, conn, channel_id):
        ent = self.channels.get(channel_id)
        return dict(ent) if ent is not None else None

    def rpc_channel_unregister(self, conn, channel_id):
        self.channels.pop(channel_id, None)
        return True


def _serve(pkg, handler, body):
    p = _proto(pkg)
    server = p.RpcServer(handler).start()
    client = p.RpcClient(server.address)
    try:
        return body(client)
    finally:
        client.close()
        server.stop()


def test_classification_sets_are_ray_tpus():
    for name in ("READONLY_RPCS", "IDEMPOTENT_RPCS", "ACKED_RETRY_RPCS",
                 "NON_RETRYABLE_RPCS"):
        extra = getattr(_proto("ray_tpu_torch"), name) - getattr(
            _proto("ray_tpu"), name)
        missing = getattr(_proto("ray_tpu"), name) - getattr(
            _proto("ray_tpu_torch"), name)
        assert not missing, (name, missing)
        assert extra == ({"spawn_stats"} if name == "READONLY_RPCS"
                         else set()), (name, extra)


# ------------------------------------------------- classification holes


def test_classification_hole_detected(witness):
    def run(pkg):
        def body(client):
            with pytest.raises(_rpc(pkg).UnclassifiedRpcError):
                client.call("totally_new_thing", timeout=5)
            return _kinds(pkg)
        return _serve(pkg, _Handler(pkg), body)

    assert _both(run) == ["classification-hole"]


def test_class_local_declaration_fills_hole(witness):
    def run(pkg):
        return _serve(pkg, _Handler(pkg), lambda c: (
            c.call("echo_local", 7, timeout=5), _kinds(pkg)))

    assert _both(run) == (7, [])


def test_classified_methods_dispatch_clean(witness):
    def run(pkg):
        return _serve(pkg, _Handler(pkg), lambda c: (
            c.call("ping", timeout=5), c.call("new_job_id", timeout=5),
            _kinds(pkg)))

    assert _both(run) == ("pong", 1, [])


# -------------------------------------------- duplicate-delivery audit


def test_idempotent_dup_accepted(witness):
    def run(pkg):
        h = _Handler(pkg)
        got = _serve(pkg, h, lambda c: c.call(
            "reserve_bundle", b"pg", 0, {"CPU": 1}, timeout=5))
        return (got, _rpc(pkg).dup_audit_counts(), _kinds(pkg), h.bundles)

    assert _both(run) == (True, {"reserve_bundle": 1}, [],
                          {(b"pg", 0): {"CPU": 1}})


def test_non_idempotent_dup_refused(witness):
    def run(pkg):
        _serve(pkg, _Handler(pkg, break_kv_put=True), lambda c: c.call(
            "kv_put", "ns", b"k", b"v", timeout=5))
        return _kinds(pkg), _rpc(pkg).violations()[0]["method"]

    assert _both(run) == (["dup-mismatch"], "kv_put")


def test_readonly_and_acked_retry_not_dup_audited(witness):
    def run(pkg):
        return _serve(pkg, _Handler(pkg), lambda c: (
            c.call("ping", timeout=5), c.call("new_job_id", timeout=5),
            c.call("new_job_id", timeout=5),
            _rpc(pkg).dup_audit_counts(), _kinds(pkg)))

    assert _both(run) == ("pong", 1, 2, {}, [])


def test_buffer_lease_dup_compared_and_released(witness):
    def run(pkg):
        h = _Handler(pkg)
        total, buf = _serve(pkg, h, lambda c: c.call(
            "fetch_chunk_local", 0, 8, timeout=5))
        return (total, bytes(buf), _rpc(pkg).dup_audit_counts(),
                _kinds(pkg), h.releases)

    assert _both(run) == (16, b"01234567", {"fetch_chunk_local": 1}, [], 2)


def test_channel_negotiation_dup_delivery_smoke(witness):
    def run(pkg):
        def body(client):
            cid = b"c" * 16
            reg = client.call("channel_register", cid, "tcp://h:1",
                              "ownerA", "node1", timeout=5)
            ent = client.call("channel_lookup", cid, timeout=5)
            unreg = client.call("channel_unregister", cid, timeout=5)
            gone = client.call("channel_lookup", cid, timeout=5)
            return (reg, ent["addr"], ent["alive"], unreg, gone,
                    _rpc(pkg).dup_audit_counts(), _kinds(pkg))
        return _serve(pkg, _ChannelHandler(), body)

    assert _both(run) == (True, "tcp://h:1", True, True, None,
                          {"channel_register": 1,
                           "channel_unregister": 1}, [])


def test_dup_nth_sampling(witness, monkeypatch):
    def run(pkg):
        def body(client):
            monkeypatch.setenv("RTPU_DEBUG_RPC_DUP_NTH", "2")
            for i in range(4):
                client.call("reserve_bundle", b"pg", i, {}, timeout=5)
            first = dict(_rpc(pkg).dup_audit_counts())
            monkeypatch.setenv("RTPU_DEBUG_RPC_DUP_NTH", "0")
            client.call("reserve_bundle", b"pg", 9, {}, timeout=5)
            return first, _rpc(pkg).dup_audit_counts()
        return _serve(pkg, _Handler(pkg), body)

    assert _both(run) == ({"reserve_bundle": 2}, {"reserve_bundle": 2})


# --------------------------------------------------- outbox ordering


def test_ordering_inversion_caught(witness):
    def run(pkg):
        rpc = _rpc(pkg)
        e1 = rpc.stamp_outbox("owner:1", [("add", b"o1", 4)])
        e2 = rpc.stamp_outbox("owner:1", [("rm", b"o1", None)])
        out2 = rpc.check_outbox("head", e2)
        rpc.check_outbox("head", e1)
        v = rpc.violations()[0]
        return out2, _kinds(pkg), v["sender"], v["receiver"]

    assert _both(run) == ([("rm", b"o1", None)], ["outbox-inversion"],
                          "owner:1", "head")


def test_redelivered_frame_caught(witness):
    def run(pkg):
        rpc = _rpc(pkg)
        e1 = rpc.stamp_outbox("node:a", [("add", b"o1", 4)])
        rpc.check_outbox("head", e1)
        rpc.check_outbox("head", list(e1))
        return _kinds(pkg)

    assert _both(run) == ["outbox-inversion"]


def test_unstamped_frame_caught(witness):
    def run(pkg):
        out = _rpc(pkg).check_outbox("head", [("add", b"o1", 4)])
        return out, _kinds(pkg)

    assert _both(run) == ([("add", b"o1", 4)], ["outbox-unstamped"])


def test_in_order_streams_clean(witness):
    def run(pkg):
        rpc = _rpc(pkg)
        outs = []
        for i in range(5):
            frame = rpc.stamp_outbox("node:a", [("add", bytes([i]), 1)])
            outs.append(rpc.check_outbox("head", frame))
        rpc.check_outbox("head", rpc.stamp_outbox("node:b",
                                                  [("rm", b"x", None)]))
        return outs, _kinds(pkg)

    outs, kinds = _both(run)
    assert outs == [[("add", bytes([i]), 1)] for i in range(5)]
    assert kinds == []


# -------------------------------------------------- flag-off contract


def test_flag_off_returns_unwrapped_dispatch(monkeypatch):
    monkeypatch.delenv("RTPU_DEBUG_RPC", raising=False)
    for pkg in PKGS:
        rpc = _rpc(pkg)
        assert not rpc.enabled()
        assert rpc.dispatch_audit("anything") is None
        entries = [("add", b"o", 1)]
        assert rpc.stamp_outbox("s", entries) is entries


def test_flag_off_unclassified_method_serves(monkeypatch):
    monkeypatch.delenv("RTPU_DEBUG_RPC", raising=False)
    for pkg in PKGS:
        assert _serve(pkg, _Handler(pkg), lambda c: c.call(
            "totally_new_thing", timeout=5)) == 1


def test_recv_seq_streams_bounded_lru(witness):
    def run(pkg):
        rpc = _rpc(pkg)
        for i in range(4096):
            rpc.check_outbox("head", rpc.stamp_outbox(
                f"node:{i}", [("add", b"o", 1)]))
        rpc.check_outbox("head", rpc.stamp_outbox("node:0",
                                                  [("add", b"o", 1)]))
        for i in range(4096, 4098):
            rpc.check_outbox("head", rpc.stamp_outbox(
                f"node:{i}", [("add", b"o", 1)]))
        clean = _kinds(pkg)
        with rpc._REGISTRY._mu:
            table = dict(rpc._REGISTRY.recv_seq)
        rpc.check_outbox("head", [(rpc.SEQ_KIND, "node:0", 1)])
        return (clean, len(table), ("node:0", "head") in table,
                ("node:1", "head") in table, ("node:2", "head") in table,
                ("node:4097", "head") in table, _kinds(pkg))

    assert _both(run) == ([], 4096, True, False, False, True,
                          ["outbox-inversion"])


def test_cluster_outbox_stream_is_stamped_and_clean(witness):
    """On the port's cluster with the flag inherited by every process:
    owners' and nodes' object_batch frames arrive stamped and in order
    at the node and the head (no outbox violation), and the flight dump
    of each process carries the witness's counts."""
    import ray_tpu_torch

    rt = ray_tpu_torch.init(num_cpus=1, object_store_memory=64 << 20)
    try:
        refs = [ray_tpu_torch.put(b"x" * (200 << 10)) for _ in range(4)]
        del refs
        ray_tpu_torch.get(ray_tpu_torch.remote(lambda: 1).remote(),
                          timeout=60)
        rt._flush_object_notifies()
        dump = rt.head.call("dump_flight", timeout=10)
        assert dump["rpc_debug"]["violations"] == 0
        assert _rpc("ray_tpu_torch").violations() == []
    finally:
        ray_tpu_torch.shutdown()
