"""Client mode on the port: a remote driver (a subprocess that is not part
of the cluster) through the gateway end to end, session-owned actors
killed on disconnect, and the gateway's wire surface (RPC names and
message shapes) held to ``ray_tpu``'s, the counterparts of
``tests/test_client_mode.py``."""

import inspect
import os
import subprocess
import sys
import textwrap
import time

import pytest

from ray_tpu.client import runtime as jclient_runtime
from ray_tpu.client import server as jserver
from ray_tpu.cluster import protocol as jprotocol

import ray_tpu_torch
from ray_tpu_torch.client import runtime as tclient_runtime
from ray_tpu_torch.client import server as tserver
from ray_tpu_torch.client.server import start_gateway
from ray_tpu_torch.cluster import protocol as tprotocol
from ray_tpu_torch.core.runtime_context import require_runtime

CLIENT_SCRIPT = textwrap.dedent("""
    import sys
    import ray_tpu_torch

    ray_tpu_torch.init(address="client://" + sys.argv[1])

    # ---- tasks ----
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(2, 3)) == 5

    # pass-by-ref args + nested refs in results
    big = ray_tpu_torch.put(list(range(1000)))
    @ray_tpu_torch.remote
    def head3(xs):
        return xs[:3]
    assert ray_tpu_torch.get(head3.remote(big)) == [0, 1, 2]

    @ray_tpu_torch.remote
    def make_ref():
        return [ray_tpu_torch.put("nested")]

    inner = ray_tpu_torch.get(make_ref.remote())
    assert ray_tpu_torch.get(inner[0]) == "nested"

    # multiple returns + wait
    @ray_tpu_torch.remote(num_returns=2)
    def two():
        return 1, 2
    r1, r2 = two.remote()
    ready, pending = ray_tpu_torch.wait([r1, r2], num_returns=2, timeout=30)
    assert len(ready) == 2 and not pending
    assert ray_tpu_torch.get([r1, r2]) == [1, 2]

    # task errors propagate
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kapow")
    try:
        ray_tpu_torch.get(boom.remote())
    except Exception as e:
        assert "kapow" in str(e), e
    else:
        raise AssertionError("expected task error")

    # ---- actors ----
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.n = start
        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert ray_tpu_torch.get(c.incr.remote()) == 11
    assert ray_tpu_torch.get(c.incr.remote(5)) == 16

    # named detached actor survives this client
    d = Counter.options(name="client-detached", lifetime="detached").remote(0)
    assert ray_tpu_torch.get(d.incr.remote()) == 1

    # named lookup from the client
    again = ray_tpu_torch.get_actor("client-detached")
    assert ray_tpu_torch.get(again.incr.remote()) == 2

    # ---- cluster info / kv ----
    assert len(ray_tpu_torch.nodes()) >= 1
    assert ray_tpu_torch.cluster_resources().get("CPU", 0) >= 1

    from ray_tpu_torch.core.runtime_context import require_runtime
    r = require_runtime()
    r.kv_put("client-key", b"v1")
    assert r.kv_get("client-key") == b"v1"
    assert "client-key" in r.kv_keys()

    ray_tpu_torch.shutdown()
    print("CLIENT_OK")
""")

DISCONNECT_SCRIPT = textwrap.dedent("""
    import os
    import sys
    import ray_tpu_torch

    ray_tpu_torch.init(address="client://" + sys.argv[1])

    @ray_tpu_torch.remote
    class Owned:
        def pid(self):
            return os.getpid()

    o = Owned.options(name="client-owned").remote()
    print("PID", ray_tpu_torch.get(o.pid.remote()))
    # exit WITHOUT shutdown: the gateway session cleanup must kill the
    # session-owned (non-detached) actor.
    print("CLIENT_EXITING")
""")


@pytest.fixture(scope="module")
def gateway():
    ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    server = start_gateway(require_runtime())
    try:
        yield server.address
    finally:
        server.stop()
        ray_tpu_torch.shutdown()


def _run_client(address: str, script: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", script, address],
        capture_output=True, text=True, timeout=180, env=dict(os.environ))


def _rpc_surface(cls):
    return {name: [p for p in inspect.signature(fn).parameters
                   if p not in ("self", "conn")]
            for name, fn in inspect.getmembers(cls, inspect.isfunction)
            if name.startswith("rpc_")}


def test_gateway_rpc_names_and_shapes_equal_ray_tpu():
    """Every gateway RPC, its arguments in order, and the client's
    runtime methods that call them, as ``ray_tpu``'s; each is classified
    in the port's protocol as in ``ray_tpu``'s."""
    got = _rpc_surface(tserver.ClientGateway)
    assert got == _rpc_surface(jserver.ClientGateway)
    for name in got:
        method = name[len("rpc_"):]
        sets = [(s, method in getattr(tprotocol, s))
                for s in ("READONLY_RPCS", "IDEMPOTENT_RPCS",
                          "ACKED_RETRY_RPCS", "NON_RETRYABLE_RPCS")]
        want = [(s, method in getattr(jprotocol, s)) for s, _ in sets]
        assert sets == want and any(v for _, v in sets), method
    public = lambda c: {n: str(inspect.signature(f)) for n, f in  # noqa: E731
                        inspect.getmembers(c, inspect.isfunction)
                        if not n.startswith("__")}
    assert public(tclient_runtime.ClientRuntime) == public(
        jclient_runtime.ClientRuntime)
    assert (tclient_runtime.ClientRuntime._RETRY_SAFE_GATEWAY
            == jclient_runtime.ClientRuntime._RETRY_SAFE_GATEWAY)


def test_client_hello_reply_equals_ray_tpu(gateway):
    """The handshake's reply shape (protocol version, node count)."""
    from ray_tpu_torch.cluster.protocol import RpcClient

    c = RpcClient(gateway)
    try:
        info = c.call("client_hello", 1, timeout=30)
    finally:
        c.close()
    assert info == {"protocol_version": 1, "num_nodes": 1}


def test_client_mode_end_to_end(gateway):
    proc = _run_client(gateway, CLIENT_SCRIPT)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "CLIENT_OK" in proc.stdout

    # The detached actor must survive the client's exit...
    handle = ray_tpu_torch.get_actor("client-detached")
    assert ray_tpu_torch.get(handle.incr.remote(), timeout=60) == 3
    ray_tpu_torch.kill(handle)


def test_client_disconnect_kills_owned_actors(gateway):
    proc = _run_client(gateway, DISCONNECT_SCRIPT)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "CLIENT_EXITING" in proc.stdout
    pid = int(proc.stdout.split("PID", 1)[1].split()[0])

    # Session cleanup is asynchronous w.r.t. process exit.
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            aid = require_runtime().get_actor("client-owned")
        except ValueError:
            break  # name gone: killed
        live = any(a.get("actor_id") == aid.hex() and
                   a.get("state") not in ("DEAD",)
                   for a in require_runtime().list_actors())
        if not live:
            break
        time.sleep(0.5)
    else:
        pytest.fail("session-owned actor was not killed on disconnect")
    deadline = time.time() + 30
    while os.path.exists(f"/proc/{pid}"):
        with open(f"/proc/{pid}/stat") as f:
            if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                break
        assert time.time() < deadline, "the owned actor's process lives on"
        time.sleep(0.1)
