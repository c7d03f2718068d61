"""The port's in-process actor runtime (``ray_tpu_torch.init(local_mode=
True)``: ``core/``, ``actor.py``, ``remote_function.py``, ``api.py``,
``util/``) against ``ray_tpu``'s.

The local-mode cases of ``tests/test_core_api.py`` (its ``local_init``
module, all 37) run once on each package, with the same values and the
same exception classes by name. Then: each flag of the port's trimmed
config equals ``ray_tpu``'s ``GLOBAL_CONFIG`` default (the two session
paths excepted, which are the port's own); ``init`` at each of
``ray_tpu``'s addresses does what ``ray_tpu``'s does; the ``GPU``
resource under its override; actor
``.bind`` raises; arguments pass by reference; the ``__ray_shutdown__``
hook runs once.
"""

import asyncio
import importlib
import os
import pathlib
import socket
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.core.config import GLOBAL_CONFIG as JCFG
from ray_tpu_torch.core.config import GLOBAL_CONFIG as TCFG

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def rt(request):
    mod = importlib.import_module(request.param)
    mod.init(local_mode=True)
    try:
        yield mod
    finally:
        mod.shutdown()


def _sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _raises(rt, name):
    """pytest.raises on the package's own exception class ``name``."""
    return pytest.raises(getattr(rt.exceptions, name))


# ------------------------------------------------ tests/test_core_api.py


def test_put_get_roundtrip(rt):
    ref = rt.put({"x": 1, "arr": np.arange(10)})
    out = rt.get(ref, timeout=10)
    assert out["x"] == 1
    assert np.array_equal(out["arr"], np.arange(10))


def test_simple_task(rt):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2), timeout=10) == 3


def test_task_with_ref_args(rt):
    @rt.remote
    def double(x):
        return 2 * x

    r1 = double.remote(10)
    r2 = double.remote(r1)
    assert rt.get(r2, timeout=10) == 40


def test_task_chaining_many(rt):
    @rt.remote
    def inc(x):
        return x + 1

    ref = rt.put(0)
    for _ in range(20):
        ref = inc.remote(ref)
    assert rt.get(ref, timeout=10) == 20


def test_multiple_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c], timeout=10) == [1, 2, 3]


def test_task_error_propagates(rt):
    @rt.remote
    def boom():
        raise ValueError("kapow")

    with _raises(rt, "TaskError") as ei:
        rt.get(boom.remote(), timeout=10)
    assert "kapow" in str(ei.value)
    assert ei.value.exc_type_name == "ValueError"


def test_dependency_error_propagates(rt):
    @rt.remote
    def boom():
        raise ValueError("root cause")

    @rt.remote
    def consume(x):
        return x

    with _raises(rt, "TaskError") as ei:
        rt.get(consume.remote(boom.remote()), timeout=10)
    assert "root cause" in str(ei.value)


def test_retries(rt):
    state = {"n": 0}

    @rt.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        state["n"] += 1
        if state["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert rt.get(flaky.remote(), timeout=10) == "ok"
    assert state["n"] == 3


def test_get_timeout(rt):
    @rt.remote
    def slow():
        time.sleep(5)

    with _raises(rt, "GetTimeoutError"):
        rt.get(slow.remote(), timeout=0.1)


def test_wait(rt):
    @rt.remote
    def sleepy(t):
        time.sleep(t)
        return t

    fast = sleepy.remote(0.01)
    slow = sleepy.remote(5)
    ready, not_ready = rt.wait([fast, slow], num_returns=1, timeout=2)
    assert ready == [fast]
    assert not_ready == [slow]


def test_wait_timeout_returns_partial(rt):
    @rt.remote
    def sleepy():
        time.sleep(5)

    refs = [sleepy.remote() for _ in range(3)]
    ready, not_ready = rt.wait(refs, num_returns=3, timeout=0.1)
    assert len(ready) == 0 and len(not_ready) == 3


def test_nested_tasks(rt):
    @rt.remote
    def inner(x):
        return x * 10

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=10) + 1

    assert rt.get(outer.remote(4), timeout=10) == 41


def test_basic_actor(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, by=1):
            self.n += by
            return self.n

        def value(self):
            return self.n

    c = Counter.remote(10)
    assert rt.get(c.inc.remote(), timeout=10) == 11
    assert rt.get(c.inc.remote(5), timeout=10) == 16
    assert rt.get(c.value.remote(), timeout=10) == 16


def test_actor_ordering(rt):
    @rt.remote
    class Appender:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)

        def get_items(self):
            return self.items

    a = Appender.remote()
    for i in range(50):
        a.add.remote(i)
    assert rt.get(a.get_items.remote(), timeout=10) == list(range(50))


def test_named_actor(rt):
    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc1").remote()
    h = rt.get_actor("svc1")
    assert rt.get(h.ping.remote(), timeout=10) == "pong"

    with pytest.raises(ValueError):
        rt.get_actor("nonexistent")


def test_named_actor_conflict_and_get_if_exists(rt):
    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="dup").remote()
    with pytest.raises(ValueError):
        Svc.options(name="dup").remote()
    h = Svc.options(name="dup", get_if_exists=True).remote()
    assert rt.get(h.ping.remote(), timeout=10) == "pong"


def test_kill_actor(rt):
    @rt.remote
    class A:
        def f(self):
            return 1

    a = A.remote()
    assert rt.get(a.f.remote(), timeout=10) == 1
    rt.kill(a)
    with _raises(rt, "ActorDiedError"):
        rt.get(a.f.remote(), timeout=10)


def test_actor_handle_pass_to_task(rt):
    @rt.remote
    class Store:
        def __init__(self):
            self.v = {}

        def set(self, k, v):
            self.v[k] = v

        def get(self, k):
            return self.v.get(k)

    @rt.remote
    def writer(store, k, v):
        rt.get(store.set.remote(k, v), timeout=10)
        return True

    s = Store.remote()
    rt.get(writer.remote(s, "a", 42), timeout=10)
    assert rt.get(s.get.remote("a"), timeout=10) == 42


def test_async_actor(rt):
    @rt.remote
    class AsyncWorker:
        async def work(self, x):
            await asyncio.sleep(0.01)
            return x * 2

    w = AsyncWorker.remote()
    refs = [w.work.remote(i) for i in range(8)]
    assert rt.get(refs, timeout=10) == [i * 2 for i in range(8)]


def test_actor_max_concurrency(rt):
    @rt.remote(max_concurrency=4)
    class Parallel:
        def __init__(self):
            self.active = 0
            self.peak = 0
            self.lock = threading.Lock()

        def work(self):
            with self.lock:
                self.active += 1
                self.peak = max(self.peak, self.active)
            time.sleep(0.05)
            with self.lock:
                self.active -= 1

        def peak_seen(self):
            return self.peak

    p = Parallel.remote()
    rt.get([p.work.remote() for _ in range(8)], timeout=10)
    assert rt.get(p.peak_seen.remote(), timeout=10) >= 2


def test_options_validation(rt):
    with pytest.raises(ValueError):
        @rt.remote(bogus_option=1)
        def f():
            pass


def test_object_ref_serialization_in_value(rt):
    inner = rt.put("inner-value")
    outer = rt.put({"nested": inner})
    got = rt.get(outer, timeout=10)
    assert rt.get(got["nested"], timeout=10) == "inner-value"


def test_large_array_zero_copyish(rt):
    arr = np.random.RandomState(0).rand(1000, 1000)
    ref = rt.put(arr)
    out = rt.get(ref, timeout=10)
    assert np.array_equal(out, arr)


def test_runtime_context(rt):
    ctx = rt.get_runtime_context()
    assert ctx.job_id is not None

    @rt.remote
    def whoami():
        c = rt.get_runtime_context()
        return c.get_task_id()

    tid = rt.get(whoami.remote(), timeout=10)
    assert tid is not None


def test_cancel(rt):
    @rt.remote
    def naptime():
        time.sleep(5)  # test_core_api's 60 s would hold the pool at exit

    ref = naptime.remote()
    rt.cancel(ref)
    # Cancellation marks the task; pending-at-dispatch tasks resolve to error.


def test_reinit_guard(rt):
    with pytest.raises(RuntimeError):
        rt.init(local_mode=True)
    rt.init(local_mode=True, ignore_reinit_error=True)


def test_method_num_returns(rt):
    @rt.remote
    class Splitter:
        @rt.method(num_returns=2)
        def split(self, s):
            mid = len(s) // 2
            return s[:mid], s[mid:]

    sp = Splitter.remote()
    a, b = sp.split.remote("abcd")
    assert rt.get(a, timeout=10) == "ab" and rt.get(b, timeout=10) == "cd"


def test_async_actor_concurrent_no_deadlock(rt):
    @rt.remote
    class Gate:
        def __init__(self):
            self.event = asyncio.Event()

        async def waiter(self):
            await self.event.wait()
            return "released"

        async def release(self):
            self.event.set()
            return "set"

    g = Gate.remote()
    w = g.waiter.remote()
    time.sleep(0.1)
    assert rt.get(g.release.remote(), timeout=10) == "set"
    assert rt.get(w, timeout=5) == "released"


def test_fire_and_forget_no_leak(rt):
    runtime = _sub(rt, "core.runtime_context").get_runtime()

    @rt.remote
    def produce():
        return list(range(1000))

    for _ in range(20):
        produce.remote()  # ref dropped immediately
    deadline = time.time() + 5
    while runtime.memory_store.size() > 0 and time.time() < deadline:
        time.sleep(0.05)
    assert runtime.memory_store.size() == 0


def test_named_actor_failed_init_frees_name(rt):
    @rt.remote
    class Bad:
        def __init__(self):
            raise RuntimeError("init boom")

    @rt.remote
    class Good:
        def ping(self):
            return "ok"

    with _raises(rt, "ActorDiedError"):
        Bad.options(name="shared-name").remote()
    h = Good.options(name="shared-name").remote()
    assert rt.get(h.ping.remote(), timeout=10) == "ok"


def test_nested_task_saturation_no_deadlock(rt):
    @rt.remote
    def child(x):
        return x + 1

    @rt.remote
    def parent(x):
        return rt.get(child.remote(x), timeout=30)

    refs = [parent.remote(i) for i in range(64)]
    assert rt.get(refs, timeout=30) == [i + 1 for i in range(64)]


def test_kill_fails_queued_calls(rt):
    """Queued method calls on a killed actor resolve with ActorDiedError
    instead of hanging (reference semantics: RayActorError on kill)."""

    @rt.remote
    class Slow:
        def work(self, t):
            time.sleep(t)
            return "done"

    a = Slow.remote()
    a.work.remote(5.0)
    r2 = a.work.remote(0.0)  # queued behind the first (max_concurrency=1)
    time.sleep(0.2)
    rt.kill(a)
    with _raises(rt, "ActorDiedError"):
        rt.get(r2, timeout=10)


def test_kill_does_not_unregister_same_name_other_namespace(rt):
    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a1 = A.options(name="x", namespace="ns1").remote()
    A.options(name="x").remote()  # default namespace
    rt.kill(a1)
    h = rt.get_actor("x")  # default-namespace actor must survive
    assert rt.get(h.ping.remote(), timeout=10) == "pong"


def test_actor_options_validated(rt):
    @rt.remote
    class A:
        pass

    with pytest.raises(ValueError):
        A.options(num_cpu=2)  # typo must raise, not be silently dropped


def test_kill_async_actor_with_inflight_call_fails_refs(rt):
    """Killing an async actor while a coroutine is awaiting must fail the
    in-flight call's refs (not hang)."""

    @rt.remote
    class Sleeper:
        async def sleep(self, t):
            await asyncio.sleep(t)
            return "done"

    a = Sleeper.remote()
    ref = a.sleep.remote(30.0)
    time.sleep(0.3)  # let the coroutine start awaiting
    rt.kill(a)
    with _raises(rt, "ActorDiedError"):
        rt.get(ref, timeout=5)


def test_actor_pool(rt):
    ActorPool = _sub(rt, "util.actor_pool").ActorPool

    @rt.remote(num_cpus=0)
    class Doubler:
        def double(self, v):
            return v * 2

    pool = ActorPool([Doubler.remote() for _ in range(3)])
    assert list(pool.map(lambda a, v: a.double.remote(v),
                         list(range(12)))) == [v * 2 for v in range(12)]
    out = sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                    list(range(8))))
    assert out == [v * 2 for v in range(8)]


def test_distributed_queue(rt):
    queue_mod = _sub(rt, "util.queue")

    q = queue_mod.Queue(maxsize=4)
    q.put("a")
    q.put_batch(["b", "c"])
    assert q.qsize() == 3
    assert q.get() == "a"

    @rt.remote
    def produce(queue, n):
        for i in range(n):
            queue.put(i)
        return n

    @rt.remote
    def consume(queue, n):
        return [queue.get(timeout=30) for _ in range(n)]

    # Submit both before getting either: the queue (maxsize=4) already holds
    # 2 items, so the producer blocks on full until the consumer drains.
    prod_ref = produce.remote(q, 5)
    cons_ref = consume.remote(q, 7)  # b, c + 0..4
    assert rt.get(prod_ref, timeout=60) == 5
    got = rt.get(cons_ref, timeout=60)
    assert got == ["b", "c", 0, 1, 2, 3, 4]
    assert q.empty()
    with pytest.raises(queue_mod.Empty):
        q.get_nowait()
    q.shutdown()


# ------------------------------------------------------- the port's own


#: Flags whose default is the port's own on purpose: the session's log
#: and spill directories, so the two packages' clusters never share one.
_OWN_DEFAULTS = ("log_dir", "object_spilling_dir")


@pytest.mark.parametrize("name", sorted(TCFG._flags))
def test_config_default_equals_ray_tpu(name):
    assert TCFG._flags[name].type is JCFG._flags[name].type
    if name in _OWN_DEFAULTS:
        path = TCFG._flags[name].default
        assert path != JCFG._flags[name].default
        assert path.startswith(tempfile.gettempdir())
        assert "ray_tpu_torch" in path
    else:
        assert TCFG._flags[name].default == JCFG._flags[name].default


def test_system_config_applies_and_unknown_flag_raises():
    try:
        ray_tpu_torch.init(local_mode=True,
                           _system_config={"serve_handle_timeout_s": 7.0})
        assert TCFG.serve_handle_timeout_s == 7.0
    finally:
        ray_tpu_torch.shutdown()
        TCFG.set("serve_handle_timeout_s",
                 TCFG._flags["serve_handle_timeout_s"].default)
    with pytest.raises(KeyError):
        TCFG.set("rpc_chaos_failure_prob", 0.5)  # not a flag of the port


def test_config_define_twice_raises():
    """One definition a flag: a second ``define`` of a name is refused and
    leaves the first in place."""
    from ray_tpu_torch.core.config import Config

    cfg = Config()
    cfg.define("x_flag", int, 1)
    with pytest.raises(ValueError, match="defined twice: x_flag"):
        cfg.define("x_flag", int, 2)
    assert cfg.x_flag == 1


def _closed_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _alive(pid):
    """True while ``pid`` runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.parametrize("kw", [{}, {"address": None}, {"address": "auto"},
                                {"address": "127.0.0.1:closed"},
                                {"address": "client://127.0.0.1:10001"}])
def test_init_at_a_cluster_address_raises(kw):
    """``init`` at each of ``ray_tpu``'s addresses does what ``ray_tpu``'s
    does (``ray_tpu/api.py:60-85``): no address starts a cluster (a head, a
    node manager, workers), and its shutdown leaves no process and no shm
    segment; ``"auto"`` and an unreachable ``host:port`` raise
    ``RuntimeError`` when the joining node cannot reach a head, within a
    bounded wait; ``client://`` raises ``NotImplementedError`` (client mode
    is not ported). The name is the one this test had while every address
    raised."""
    kw = dict(kw)
    if kw.get("address") == "127.0.0.1:closed":
        kw["address"] = f"127.0.0.1:{_closed_port()}"
    address = kw.get("address")
    if address is None:
        rt = ray_tpu_torch.init(num_cpus=1, object_store_memory=32 << 20,
                                **kw)
        try:
            procs = list(rt._procs)
            segments = [n.store_name for n in rt._nodes]

            @ray_tpu_torch.remote
            def pid():
                return os.getpid()

            worker = ray_tpu_torch.get(pid.remote(), timeout=60)
            assert ray_tpu_torch.cluster_resources()["CPU"] == 1.0
            assert len(procs) == 2 and worker not in (os.getpid(),
                                                      *(p.pid for p in procs))
        finally:
            ray_tpu_torch.shutdown()
        assert not ray_tpu_torch.is_initialized()
        deadline = time.monotonic() + 10
        while any(_alive(p) for p in (worker, *(p.pid for p in procs))):
            assert time.monotonic() < deadline, "a cluster process outlived it"
            time.sleep(0.1)
        for name in segments:
            assert not pathlib.Path("/dev/shm", name.lstrip("/")).exists()
        return
    if address.startswith("client://"):
        with pytest.raises(NotImplementedError, match="client mode"):
            ray_tpu_torch.init(**kw)
    else:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="before printing ADDRESS"):
            ray_tpu_torch.init(**kw)
        assert time.monotonic() - t0 < 30
    assert not ray_tpu_torch.is_initialized()


@pytest.mark.parametrize("env,want", [("2", 2.0), ("0", None)])
def test_gpu_resource_under_its_override(monkeypatch, env, want):
    monkeypatch.setenv("RTPU_GPUS", env)
    ray_tpu_torch.init(local_mode=True)
    try:
        res = ray_tpu_torch.cluster_resources()
        assert res.get("GPU") == want
        assert "TPU" not in res and res["CPU"] >= 1
    finally:
        ray_tpu_torch.shutdown()


def test_gpu_resource_counts_the_cards(monkeypatch):
    monkeypatch.delenv("RTPU_GPUS", raising=False)
    ray_tpu_torch.init(local_mode=True)
    try:
        got = ray_tpu_torch.cluster_resources().get("GPU")
    finally:
        ray_tpu_torch.shutdown()
    assert got == (float(torch.cuda.device_count()) or None)


def test_actor_bind_raises_not_implemented(monkeypatch):
    """``.bind`` builds a compiled-DAG node, as ``ray_tpu``'s does. The
    local runtime places no actor on a node, so compiling over its actors
    raises what ``ray_tpu``'s local runtime raises, a ``TimeoutError``
    once the placement wait ends (60 s there and here; cut to 0.2 s for
    the test)."""
    from ray_tpu_torch.dag import ClassMethodNode, InputNode, compiled_dag

    ray_tpu_torch.init(local_mode=True)
    try:
        @ray_tpu_torch.remote
        class A:
            def f(self, x):
                return x

        a = A.remote()
        with InputNode() as inp:
            node = a.f.bind(inp)
        assert isinstance(node, ClassMethodNode)
        assert (node.actor, node.method_name, node.args, node.kwargs) == (
            a, "f", (inp,), {})
        assert node.upstream() == [inp]
        const = a.f.bind(1, k=2)
        assert const.args == (1,) and const.kwargs == {"k": 2}
        assert compiled_dag.PLACEMENT_TIMEOUT_S == 60.0
        monkeypatch.setattr(compiled_dag, "PLACEMENT_TIMEOUT_S", 0.2)
        with pytest.raises(TimeoutError, match="not placed"):
            node.experimental_compile()
    finally:
        ray_tpu_torch.shutdown()


def test_arguments_pass_by_reference():
    """Nothing on the actor path copies: the tensor an actor receives, and
    the one a task returns, are the caller's."""
    ray_tpu_torch.init(local_mode=True)
    try:
        t = torch.arange(4.0)

        @ray_tpu_torch.remote
        class Holder:
            def __init__(self, tree):
                self.tree = tree

            def same(self, x):
                return x is self.tree["w"]

        @ray_tpu_torch.remote
        def echo(x):
            return x

        h = Holder.remote({"w": t})
        assert ray_tpu_torch.get(h.same.remote(t), timeout=10)
        assert ray_tpu_torch.get(echo.remote(t), timeout=10) is t
        assert ray_tpu_torch.get(ray_tpu_torch.put(t), timeout=10) is t
    finally:
        ray_tpu_torch.shutdown()


def test_ray_shutdown_hook_runs_once_on_kill_and_shutdown():
    calls = []

    class Owner:
        def __init__(self, tag):
            self.tag = tag

        def ping(self):
            return self.tag

        def __ray_shutdown__(self):
            calls.append(self.tag)

    ray_tpu_torch.init(local_mode=True)
    try:
        cls = ray_tpu_torch.remote(Owner)
        a, b = cls.remote("a"), cls.remote("b")
        assert ray_tpu_torch.get([a.ping.remote(), b.ping.remote()],
                                 timeout=10) == ["a", "b"]
        ray_tpu_torch.kill(a)
        ray_tpu_torch.kill(a)
        assert calls == ["a"]
    finally:
        ray_tpu_torch.shutdown()
    assert sorted(calls) == ["a", "b"]
