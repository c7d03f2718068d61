"""The port's HTTP and gRPC ingress (``ray_tpu_torch/serve/_private/
proxy.py`` and ``grpc_proxy.py``) against ``ray_tpu``'s.

- The wire, held against ``ray_tpu``'s aiohttp proxy: both
  ``HTTPProxyActor``s are built as plain objects in this process and given
  the same stub handles (their ``_handles`` dict, ``status`` and
  ``get_deployment_handle`` patched); the same requests over
  ``http.client`` must get the same status, ``Content-Type``, JSON body and
  stream lines — a reply, a stream, a stream that raises mid-way, a
  handle that raises, bad JSON, an empty path, an unknown deployment, a
  shed request, ``/-/healthz``, ``/-/routes`` and ``/-/slo``. Then the
  port's own: keep-alive, chunked request bodies, a client that hangs up
  mid-stream cancels the generator, ``stop`` frees the port.
- Counterparts of ``ray_tpu``'s proxy tests on the port's cluster
  (``tests/test_serve.py::test_http_proxy_end_to_end``,
  ``test_serve_streaming.py::test_http_chunked_streaming``,
  ``test_serve_dataplane.py``'s proxy concurrency and gRPC cases, the
  per-node proxies and the SLO gate's HTTP 503).
- The slice end to end: a ``tiny_config`` Llama on ``ray_tpu``'s weights
  behind ``start_http_per_node()``; ``POST /<name>`` with ``prompt_ids``
  as a reply and as a stream gives ``ray_tpu``'s engine's greedy tokens,
  and the replica's ``rtpu_llm_requests_total`` and
  ``rtpu_llm_tokens_generated_total``, read from the head's KV, count
  exactly what was sent.
"""

import asyncio
import http.client
import json
import re
import socket
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve

PACKAGES = ("ray_tpu", "ray_tpu_torch")


# ------------------------------------------------------------ stub handles


class _Resp:
    def __init__(self, fn):
        self._fn = fn

    async def result_async(self, timeout=None):
        return self._fn()


class _Gen:
    def __init__(self, items, fail_after=None, delay=0.0):
        self._items = list(items)
        self._fail_after = fail_after
        self._delay = delay
        self._i = 0
        self.cancelled = threading.Event()

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._delay:
            await asyncio.sleep(self._delay)
        if self._fail_after is not None and self._i == self._fail_after:
            raise ValueError("generator broke at item %d" % self._i)
        if self._i >= len(self._items) or self.cancelled.is_set():
            raise StopAsyncIteration
        self._i += 1
        return self._items[self._i - 1]

    def cancel(self):
        self.cancelled.set()


class _Handle:
    """The deployment handle surface a proxy uses: ``options(method,
    stream=)`` then ``remote(payload)``."""

    def __init__(self, behaviour, method="__call__", stream=False):
        self._b = behaviour
        self._method = method
        self._stream = stream
        self.gens = []

    def options(self, method=None, stream=False):
        h = _Handle(self._b, method or self._method, stream)
        h.gens = self.gens
        return h

    def remote(self, payload):
        if self._stream:
            g = self._b(self._method, payload, True)
            self.gens.append(g)
            return g
        return _Resp(lambda: self._b(self._method, payload, False))


def _echo(method, payload, stream):
    if stream:
        n = int(payload.get("n", 3)) if isinstance(payload, dict) else 3
        if method == "broken":
            return _Gen(range(n), fail_after=2)
        return _Gen([{"i": i, "m": method} for i in range(n)])
    if method == "fail":
        raise RuntimeError("handle failed: boom")
    return {"method": method, "payload": payload}


def _slow_stream(method, payload, stream):
    return _Gen(range(1000), delay=0.05)


ROUTES = {"echo": {"num_replicas": 1, "version": 0}}


def _proxy(pkg, monkeypatch, shed_name="hot", budget_ms=1.0):
    import importlib

    proxy_mod = importlib.import_module(f"{pkg}.serve._private.proxy")
    slo = importlib.import_module(f"{pkg}.serve._private.slo")
    api = importlib.import_module(f"{pkg}.serve.api")
    monkeypatch.setattr(api, "status", lambda: dict(ROUTES))

    def _no_such(name):
        raise KeyError(f"no deployment named {name!r}")

    monkeypatch.setattr(api, "get_deployment_handle", _no_such)
    p = proxy_mod.HTTPProxyActor("127.0.0.1", 0)
    p._handles["echo"] = _Handle(_echo)
    p._handles["slow"] = _Handle(_slow_stream)
    p._handles[shed_name] = _Handle(_echo)
    # One over-budget sample and no queue: every request to shed_name is
    # shed at the gate, the others admitted (a cold deployment never gates;
    # budget_ms=0 turns the gate off for tests that send several).
    p._admission = slo.AdmissionController(
        budget_ms=budget_ms, queue_depth=0, min_samples=1, probe_inflight=0)
    p._admission.record_ttft(shed_name, 50.0)
    return p


@pytest.fixture
def proxies(monkeypatch):
    pytest.importorskip("aiohttp")  # ray_tpu's proxy is aiohttp's
    made = {pkg: _proxy(pkg, monkeypatch) for pkg in PACKAGES}
    try:
        yield made
    finally:
        for p in made.values():
            p.stop()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


CASES = [
    ("reply", "POST", "/echo", json.dumps({"x": 1})),
    ("reply_method", "POST", "/echo/other", json.dumps([1, 2])),
    ("reply_empty_body", "POST", "/echo", b""),
    ("handle_raises", "POST", "/echo/fail", json.dumps({})),
    ("stream", "POST", "/echo?stream=1", json.dumps({"n": 4})),
    ("stream_method", "POST", "/echo/gen?stream=1", json.dumps({"n": 2})),
    ("stream_raises_midway", "POST", "/echo/broken?stream=1",
     json.dumps({"n": 5})),
    ("bad_json", "POST", "/echo", b"{not json"),
    ("empty_path", "POST", "/", json.dumps({})),
    ("unknown_deployment", "POST", "/nope", json.dumps({})),
    ("unknown_deployment_stream", "POST", "/nope?stream=1", json.dumps({})),
    ("shed", "POST", "/hot", json.dumps({"prompt_ids": [1, 2, 3]})),
    ("healthz", "GET", "/-/healthz", None),
    ("routes", "GET", "/-/routes", None),
]


def _decoded(ctype, body):
    if ctype and ctype.startswith("application/jsonlines"):
        return [json.loads(line) for line in body.decode().splitlines()]
    if ctype and ctype.startswith("application/json"):
        return json.loads(body)
    return body.decode()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_wire_equals_ray_tpus_proxy(proxies, case):
    _name, method, path, body = case
    got = {}
    for pkg, p in proxies.items():
        status, ctype, raw = _request(p.port, method, path, body,
                                      {"Content-Type": "application/json"})
        got[pkg] = (status, ctype, _decoded(ctype, raw), raw)
    ref, port = got["ray_tpu"], got["ray_tpu_torch"]
    assert port[:3] == ref[:3]
    if not (ref[1] or "").startswith("application/jsonlines"):
        assert port[3] == ref[3]  # the JSON bytes, not only the values


def test_slo_snapshot_equals_after_the_same_traffic(proxies):
    for p in proxies.values():
        # This host's TTFTs would decide whether the next /echo is over
        # the 1 ms budget: both gates record the same 0.1 ms instead.
        orig = p._admission.record_ttft
        p._admission.record_ttft = (
            lambda name, _ms, tenant=None, _o=orig: _o(name, 0.1, tenant))
        for path in ("/echo", "/hot", "/echo"):
            _request(p.port, "POST", path, json.dumps({"prompt_ids": [5]}),
                     {"x-tenant": "t1"})
    snaps = {pkg: json.loads(_request(p.port, "GET", "/-/slo")[2])
             for pkg, p in proxies.items()}
    assert snaps["ray_tpu_torch"] == snaps["ray_tpu"]


def test_keep_alive_and_chunked_request_body(monkeypatch):
    p = _proxy("ray_tpu_torch", monkeypatch, budget_ms=0.0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", p.port, timeout=30)
        outs = []
        for i in range(3):
            conn.request("POST", "/echo", body=json.dumps({"i": i}))
            r = conn.getresponse()
            outs.append(json.loads(r.read()))
        # One socket serves all three (keep-alive), then a chunked body.
        conn.request("POST", "/echo?stream=1",
                     body=iter([b'{"n"', b': 2}']),
                     encode_chunked=True,
                     headers={"Transfer-Encoding": "chunked"})
        lines = conn.getresponse().read().decode().splitlines()
        # The same socket serves on after a stream.
        conn.request("POST", "/echo", body=json.dumps({"i": 3}))
        after = json.loads(conn.getresponse().read())
        conn.close()
        assert after["result"]["payload"] == {"i": 3}
        assert [o["result"]["payload"]["i"] for o in outs] == [0, 1, 2]
        assert [json.loads(x) for x in lines] == [
            {"item": {"i": 0, "m": "__call__"}},
            {"item": {"i": 1, "m": "__call__"}}]
    finally:
        p.stop()


def test_client_hang_up_cancels_the_generator(monkeypatch):
    p = _proxy("ray_tpu_torch", monkeypatch)
    try:
        s = socket.create_connection(("127.0.0.1", p.port), timeout=30)
        s.sendall(b"POST /slow?stream=1 HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 2\r\n\r\n{}")
        got = b""
        while b'{"item": 0}' not in got:
            got += s.recv(4096)
        s.close()
        gens = p._handles["slow"].gens
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not gens[0].cancelled.is_set():
            time.sleep(0.05)
        assert gens[0].cancelled.is_set()
        assert gens[0]._i < 100  # stopped long before the 1000 items
        # The proxy still serves.
        assert _request(p.port, "GET", "/-/healthz")[0] == 200
    finally:
        p.stop()


def test_stop_closes_the_listening_socket(monkeypatch):
    p = _proxy("ray_tpu_torch", monkeypatch)
    assert p.healthy()
    port = p.port
    p.stop()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and p.healthy():
        time.sleep(0.05)
    assert not p.healthy()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    assert re.fullmatch(r"[\d.]+:\d+", p.address())


def test_configure_qos_reaches_the_gate(monkeypatch):
    p = _proxy("ray_tpu_torch", monkeypatch)
    try:
        assert p.configure_qos({"gold": {"weight": 4.0, "priority": 1}})
        _request(p.port, "POST", "/echo", json.dumps({"tenant": "gold"}))
        snap = json.loads(_request(p.port, "GET", "/-/slo")[2])
        gold = snap["echo"]["tenants"]["gold"]
        assert gold["weight"] == 4.0 and gold["priority"] == 1
    finally:
        p.stop()


def test_start_grpc_names_grpc_when_it_is_missing(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_grpc(name, *a, **kw):
        if name == "grpc" or name.startswith("grpc."):
            raise ImportError("No module named 'grpc'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_grpc)
    with pytest.raises(ImportError, match="grpc"):
        serve.start_grpc()


# --------------------------------------------- deploy_config, held to ray_tpu

DEPLOY = {"applications": [
    {"name": "calc", "import_path": "{fixture}:build", "args": {"bias": 9},
     "deployments": [
         {"name": "Adder", "num_replicas": 3,
          "ray_actor_options": {"num_cpus": 0},
          "autoscaling_config": {"min_replicas": 1, "max_replicas": 4}},
         {"name": "Front", "max_ongoing_requests": 4,
          "user_config": {"k": 1}}]},
    {"name": "calc2", "import_path": "{fixture}:app"}]}


def _graph(dep):
    from ray_tpu.serve.api import Deployment as JD
    from ray_tpu_torch.serve.api import Deployment as TD

    def conv(v):
        return _graph(v) if isinstance(v, (JD, TD)) else v

    return {"name": dep.name, "cls": dep._cls.__name__,
            "config": dep._config,
            "args": [conv(a) for a in dep._init_args],
            "kwargs": {k: conv(v) for k, v in dep._init_kwargs.items()}}


def _deployed(pkg, fixture, config):
    import importlib

    schema = importlib.import_module(f"{pkg}.serve.schema")
    runs = []
    stub = types.SimpleNamespace(
        run=lambda dep, name=None: runs.append((name, _graph(dep))) or name)
    cfg = json.loads(json.dumps(config).replace("{fixture}", fixture))
    handles = schema.deploy_config(cfg, _serve=stub)
    return handles, runs


def test_deploy_config_gives_ray_tpus_deployment_configs(tmp_path):
    """The same config (as a dict and as YAML text) through both packages'
    ``deploy_config``: the same applications, deployment names, classes,
    overridden configs and bound graphs; an unknown override raises in
    both."""
    pytest.importorskip("yaml")
    import yaml

    ref = _deployed("ray_tpu", "tests.serve_app_fixture", DEPLOY)
    got = _deployed("ray_tpu_torch", "tests.torch_serve_app_fixture",
                    DEPLOY)
    assert got == ref
    assert ref[1][0][1]["args"][0]["config"]["num_replicas"] == 3
    text = yaml.safe_dump(json.loads(json.dumps(DEPLOY).replace(
        "{fixture}", "tests.torch_serve_app_fixture")))
    from ray_tpu_torch.serve import schema

    assert schema.deploy_config(text, _serve=types.SimpleNamespace(
        run=lambda dep, name=None: name)) == {"calc": "calc",
                                              "calc2": "calc2"}
    bad = {"applications": [{"name": "x", "import_path":
                             "{fixture}:app", "deployments": [
                                 {"name": "Adder", "bogus": 1}]}]}
    for pkg, fixture in (("ray_tpu", "tests.serve_app_fixture"),
                         ("ray_tpu_torch", "tests.torch_serve_app_fixture")):
        with pytest.raises(ValueError, match="unsupported override"):
            _deployed(pkg, fixture, bad)


# ------------------------------------------------ on the port's cluster


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(
        num_cpus=4, object_store_memory=256 << 20,
        _system_config={"metrics_report_period_ms": 300})
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


def _post(url, payload, timeout=60, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_proxy_end_to_end(cluster):
    """``tests/test_serve.py::test_http_proxy_end_to_end``."""

    @serve.deployment(name="adder")
    class Adder:
        def __call__(self, payload):
            return {"sum": payload["a"] + payload["b"]}

    serve.run(Adder.bind())
    proxy, port = serve.start_http()
    try:
        out = _post(f"http://127.0.0.1:{port}/adder", {"a": 2, "b": 3})
        assert out == {"result": {"sum": 5}}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{port}/missing", {})
        assert ei.value.code == 404
    finally:
        ray_tpu_torch.get(proxy.stop.remote(), timeout=30)
        ray_tpu_torch.kill(proxy)
        serve.delete("adder")


def test_http_chunked_streaming(cluster):
    """``tests/test_serve_streaming.py::test_http_chunked_streaming``."""

    @serve.deployment(name="streamer")
    class Streamer:
        def gen(self, payload):
            for i in range(payload["n"]):
                yield {"i": i}

    serve.run(Streamer.bind())
    proxy, port = serve.start_http()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/streamer/gen?stream=1",
            data=json.dumps({"n": 4}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["Content-Type"] == "application/jsonlines"
            lines = [json.loads(x) for x in r.read().decode().splitlines()]
        assert lines == [{"item": {"i": i}} for i in range(4)]
    finally:
        ray_tpu_torch.get(proxy.stop.remote(), timeout=30)
        ray_tpu_torch.kill(proxy)
        serve.delete("streamer")


def test_slow_stream_over_http_and_async_iteration(cluster):
    """A stream whose items come slower than the start RPC's first-chunk
    wait: the handle's async iteration polls the replica's cursor (each
    poll's ref is held until it lands), and the proxy delivers every item
    and keeps the connection for the next request."""

    @serve.deployment(name="trickle")
    class Trickle:
        def gen(self, payload):
            for i in range(3):
                time.sleep(0.6)
                yield i

        def __call__(self, payload):
            return "after"

    h = serve.run(Trickle.bind())

    async def drain():
        return [x async for x in h.options("gen", stream=True).remote({})]

    assert asyncio.run(asyncio.wait_for(drain(), 60)) == [0, 1, 2]
    proxy, port = serve.start_http()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/trickle/gen?stream=1", body=b"{}")
        lines = conn.getresponse().read().decode().splitlines()
        assert [json.loads(x) for x in lines] == [{"item": i}
                                                  for i in range(3)]
        conn.request("POST", "/trickle", body=b"{}")
        assert json.loads(conn.getresponse().read()) == {"result": "after"}
        conn.close()
    finally:
        ray_tpu_torch.kill(proxy)
        serve.delete("trickle")


def test_proxy_concurrency_and_per_node_reconcile(cluster):
    """``tests/test_serve_dataplane.py::test_proxy_concurrency_latency``
    (concurrent requests multiplexed on one event loop) over the
    controller's per-node proxies, which ``list_proxies`` reports and a
    second ``start_http_per_node`` reuses."""

    @serve.deployment(name="sleeper", num_replicas=2,
                      max_ongoing_requests=16)
    class Sleeper:
        def __call__(self, payload):
            time.sleep(0.2)
            return payload["i"]

    serve.run(Sleeper.bind())
    addrs = serve.start_http_per_node()
    assert len(addrs) == len([n for n in ray_tpu_torch.nodes()
                              if n.get("alive", True)])
    assert serve.start_http_per_node() == addrs
    addr = next(iter(addrs.values()))
    out = [None] * 16

    def one(i):
        out[i] = _post(f"http://{addr}/sleeper", {"i": i})["result"]

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    took = time.monotonic() - t0
    assert out == list(range(16))
    # 16 x 0.2 s serially would be 3.2 s; 2 replicas x 16 slots overlap.
    assert took < 3.0, took
    controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
    assert ray_tpu_torch.get(controller.list_proxies.remote(),
                             timeout=30) == addrs
    routes = json.loads(urllib.request.urlopen(
        f"http://{addr}/-/routes", timeout=30).read())
    assert "sleeper" in routes
    serve.delete("sleeper")


def test_grpc_ingress_unary_and_streaming(cluster):
    """``tests/test_serve_dataplane.py::test_grpc_ingress_unary_and_
    streaming``: unary + server-streaming through generic handlers,
    NOT_FOUND for unknown deployments."""
    grpc = pytest.importorskip("grpc")

    @serve.deployment(name="gsvc")
    class GSvc:
        def __call__(self, p):
            return {"doubled": p.get("n", 0) * 2}

        def gen(self, p):
            for i in range(p.get("k", 3)):
                yield {"i": i}

    serve.run(GSvc.bind())
    proxy, port = serve.start_grpc()
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        unary = chan.unary_unary("/ray_tpu.serve/gsvc",
                                 request_serializer=bytes,
                                 response_deserializer=bytes)
        out = json.loads(unary(json.dumps({"n": 21}).encode(), timeout=60))
        assert out["result"]["doubled"] == 42
        stream = chan.unary_stream("/ray_tpu.serve/gsvc.gen",
                                   request_serializer=bytes,
                                   response_deserializer=bytes)
        frames = [json.loads(f) for f in stream(
            json.dumps({"k": 4}).encode(), timeout=60,
            metadata=(("rtpu-stream", "1"),))]
        assert [f["item"]["i"] for f in frames] == [0, 1, 2, 3]
        missing = chan.unary_unary("/ray_tpu.serve/nosuchdep",
                                   request_serializer=bytes,
                                   response_deserializer=bytes)
        with pytest.raises(grpc.RpcError) as ei:
            missing(b"{}", timeout=60)
        assert ei.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        chan.close()
        ray_tpu_torch.kill(proxy)
        serve.delete("gsvc")


def test_yaml_declarative_deploy(cluster, tmp_path):
    """``tests/test_serve_dataplane.py::test_yaml_declarative_deploy``,
    over ``tests/torch_serve_app_fixture.py`` (the port's import_path
    target; a worker imports it by name, so it imports no JAX)."""
    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text("""
applications:
  - name: calc
    import_path: tests.torch_serve_app_fixture:build
    args: {bias: 100}
    deployments:
      - name: Adder
        num_replicas: 2
        ray_actor_options: {num_cpus: 0}
      - name: Front
        max_ongoing_requests: 4
""")
    handles = serve.deploy_config(str(cfg_path))
    assert set(handles) == {"calc"}
    out = handles["calc"].remote({"x": 1}).result(timeout=60)
    assert out == {"front": True, "sum": 101}
    assert serve.status()["Adder"]["num_replicas"] == 2
    handles2 = serve.deploy_config(
        {"applications": [{"name": "calc2",
                           "import_path":
                               "tests.torch_serve_app_fixture:app"}]})
    out2 = handles2["calc2"].remote({"x": 2}).result(timeout=60)
    assert out2 == {"front": True, "sum": 7}
    for name in ("calc", "calc2", "Adder", "Front"):
        try:
            serve.delete(name)
        except Exception:
            pass


# --------------------------------------------------- the slice, end to end

BASE = dict(max_batch=2, max_len=128, prompt_buckets=[16, 32, 64],
            decode_chunk=4, prefix_block=16, seed=0)
NEW = 6
_rng = np.random.RandomState(5)
PROMPTS = [_rng.randint(1, 256, n).tolist() for n in (7, 19, 33)]


@pytest.fixture(scope="module")
def weights():
    import jax

    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.models import llama as tllama

    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(17))
    tcfg = tllama.tiny_config(max_seq_len=128)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return jcfg, jparams, tcfg, tllama.from_jax_params(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def jax_tokens(weights):
    from ray_tpu.serve.llm import LLMEngine as JEngine

    jcfg, jparams = weights[0], weights[1]
    eng = JEngine(cfg=jcfg, params=jparams, **BASE)
    try:
        return [eng.generate(p, max_new_tokens=NEW)["token_ids"]
                for p in PROMPTS]
    finally:
        eng.close()


def _published(name):
    """``name``'s samples summed over every process that published its
    registry to the head's KV (``metrics/<node>[/<pid>]``)."""
    from ray_tpu_torch.core.runtime_context import require_runtime

    head = require_runtime().head
    total = 0.0
    for key in head.retrying_call("kv_keys", "default", b"metrics/",
                                  timeout=10):
        text = head.retrying_call("kv_get", "default", key, timeout=10)
        for line in (text or b"").decode().splitlines():
            if line.startswith(name + "{") or line.startswith(name + " "):
                total += float(line.rsplit(" ", 1)[1])
    return total


def test_llm_over_http_matches_ray_tpus_engine(cluster, weights,
                                                jax_tokens):
    from ray_tpu_torch.serve.llm import build_llm_deployment

    tcfg, tparams = weights[2], weights[3]
    req0 = _published("rtpu_llm_requests_total")
    tok0 = _published("rtpu_llm_tokens_generated_total")
    serve.run(build_llm_deployment(
        "httpllm", engine_kwargs=dict(cfg=tcfg, params=tparams,
                                      device="cpu", **BASE)))
    addr = next(iter(serve.start_http_per_node().values()))
    try:
        replies = [_post(f"http://{addr}/httpllm",
                         {"prompt_ids": p, "max_new_tokens": NEW})["result"]
                   for p in PROMPTS]
        assert [r["token_ids"] for r in replies] == jax_tokens
        streams = []
        for p in PROMPTS:
            req = urllib.request.Request(
                f"http://{addr}/httpllm/stream?stream=1",
                data=json.dumps({"prompt_ids": p,
                                 "max_new_tokens": NEW}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                streams.append([json.loads(x)["item"] for x in
                                r.read().decode().splitlines()])
        assert streams == jax_tokens
        sent = 2 * len(PROMPTS)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            reqs = _published("rtpu_llm_requests_total") - req0
            toks = _published("rtpu_llm_tokens_generated_total") - tok0
            if reqs == sent and toks == sent * NEW:
                break
            time.sleep(0.2)
        assert (reqs, toks) == (sent, sent * NEW)
    finally:
        serve.delete("httpllm")


def test_overload_sheds_503_over_http(cluster):
    """``tests/test_serve_slo.py::test_overload_sheds_503_and_bounds_
    admitted_ttft``'s HTTP half: a gate over its budget with no queue
    sheds with 503 and the ``overloaded`` body."""
    from ray_tpu_torch.serve._private.proxy import HTTPProxyActor

    @serve.deployment(name="slowish")
    class Slowish:
        def __call__(self, payload):
            time.sleep(0.05)
            return "ok"

    serve.run(Slowish.bind())
    p = HTTPProxyActor("127.0.0.1", 0)
    from ray_tpu_torch.serve._private.slo import AdmissionController

    p._admission = AdmissionController(budget_ms=1.0, queue_depth=0,
                                       min_samples=1, probe_inflight=0)
    try:
        assert _post(f"http://127.0.0.1:{p.port}/slowish", {})["result"] \
            == "ok"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{p.port}/slowish", {})
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["error"] == "overloaded"
        assert body["deployment"] == "slowish"
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{p.port}/-/slo", timeout=30).read())
        assert snap["slowish"]["shed_total"] == 1
    finally:
        p.stop()
        serve.delete("slowish")
