"""The port's serve stack (``ray_tpu_torch.serve``: controller, router,
replicas, handles) on its in-process runtime, against ``ray_tpu``'s.

- ``tests/test_serve_local_mode.py``'s three cases, on both packages.
- Deployments through the controller on each package's ``LocalRuntime``
  (``init(local_mode=True)``): method routing and ``status``, redeploy,
  a killed replica rerouted, composition, streaming (items, errors,
  cancel), ``delete``, and load snapshots reaching the router.
- The ``__new__``-built router cases of ``tests/test_serve_routing.py``
  and ``tests/test_kv_fleet.py::test_router_fleet_term_scores_spilled_
  residency``: each scenario runs on ``ray_tpu``'s ``Router`` and on the
  port's, fed the same snapshots after the same ``random.seed``; their
  choices, route counters and scores must be equal.
- The port's own: ``autoscaling_config`` is kept as ``ray_tpu`` keeps it,
  and ``serve.shutdown()`` leaves no serve thread running.
"""

import asyncio
import collections
import importlib
import random
import threading
import time
import types

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def _serve(pkg):
    return importlib.import_module(f"{pkg}.serve")


@pytest.fixture(params=PACKAGES)
def served(request):
    """(package, its serve module) on a fresh local runtime."""
    pkg = importlib.import_module(request.param)
    serve = _serve(request.param)
    pkg.init(local_mode=True)
    try:
        yield pkg, serve
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()


# ----------------------------------------- tests/test_serve_local_mode.py


@pytest.mark.parametrize("pkg", PACKAGES)
def test_local_mode_needs_no_cluster(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

        def plus(self, x, y):
            return x + y

    h = serve.run(Doubler.bind(), _local_testing_mode=True)
    assert h.remote(21).result(timeout=10) == 42
    assert h.plus.remote(1, y=2).result(timeout=10) == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_local_mode_composition(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class Tokenizer:
        def __call__(self, text):
            return text.split()

    @serve.deployment
    class Pipeline:
        def __init__(self, tok):
            self.tok = tok

        def __call__(self, text):
            return len(self.tok.remote(text).result(timeout=10))

    h = serve.run(Pipeline.bind(Tokenizer.bind()),
                  _local_testing_mode=True)
    assert h.remote("a b c d").result(timeout=10) == 4


@pytest.mark.parametrize("pkg", PACKAGES)
def test_local_mode_async_result(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class Echo:
        def __call__(self, x):
            return x

    h = serve.run(Echo.bind(), _local_testing_mode=True)

    async def go():
        return await h.remote("hi").result_async(timeout=10)

    assert asyncio.run(go()) == "hi"


# ------------------------------------ deployments through the controller


def test_deploy_and_route(served):
    _, serve = served

    @serve.deployment(num_replicas=2)
    class Doubler:
        def __call__(self, x):
            return x * 2

        def plus(self, x, y=0):
            return x + y

    handle = serve.run(Doubler.bind())
    assert handle.remote(21).result(timeout=30) == 42
    assert handle.options("plus").remote(1, y=2).result(timeout=30) == 3
    assert handle.plus.remote(5, y=5).result(timeout=30) == 10
    st = serve.status()
    assert st["Doubler"]["num_replicas"] == 2
    again = serve.get_deployment_handle("Doubler")
    assert again.remote(4).result(timeout=30) == 8


def test_redeploy_updates_code(served):
    _, serve = served

    @serve.deployment(name="ver")
    class V1:
        def __call__(self, _):
            return "v1"

    h = serve.run(V1.bind())
    assert h.remote(None).result(timeout=30) == "v1"

    @serve.deployment(name="ver")
    class V2:
        def __call__(self, _):
            return "v2"

    h = serve.run(V2.bind())
    assert h.remote(None).result(timeout=30) == "v2"


def test_replica_failure_rerouted(served):
    pkg, serve = served

    @serve.deployment(name="ft", num_replicas=2)
    class FT:
        def __call__(self, x):
            return x + 1

    h = serve.run(FT.bind())
    assert h.remote(1).result(timeout=30) == 2
    controller = pkg.get_actor("rtpu-serve-controller")
    replicas = pkg.get(controller.get_replicas.remote("ft"), timeout=30)
    pkg.kill(replicas[0])
    ok = 0
    deadline = time.time() + 60
    while ok < 5 and time.time() < deadline:
        try:
            assert h.remote(1).result(timeout=10) == 2
            ok += 1
        except Exception:
            time.sleep(0.5)
    assert ok >= 5


def test_composition_through_handles(served):
    _, serve = served

    @serve.deployment
    class Tokenizer:
        def __call__(self, text):
            return text.split()

    @serve.deployment
    class Pipeline:
        def __init__(self, tok):
            self.tok = tok

        def __call__(self, text):
            return len(self.tok.remote(text).result(timeout=30))

    h = serve.run(Pipeline.bind(Tokenizer.bind()))
    assert h.remote("a b c d").result(timeout=30) == 4
    assert set(serve.status()) == {"Pipeline", "Tokenizer"}


def test_streaming_items_errors_and_cancel(served):
    _, serve = served

    @serve.deployment
    class Gen:
        def count(self, n):
            for i in range(n):
                yield i

        def broken(self, n):
            for i in range(n):
                yield i
            raise ValueError("mid-stream")

        def forever(self):
            i = 0
            while True:
                yield i
                i += 1
                time.sleep(0.01)

    h = serve.run(Gen.bind())
    assert list(h.options("count", stream=True).remote(5)) == [0, 1, 2, 3, 4]
    assert list(h.options("count", stream=True).remote(0)) == []
    got = []
    with pytest.raises(Exception, match="mid-stream"):
        for x in h.options("broken", stream=True).remote(3):
            got.append(x)
    assert got == [0, 1, 2]
    gen = h.options("forever", stream=True).remote()
    assert next(gen) == 0
    gen.cancel()
    with pytest.raises(StopIteration):
        while True:
            next(gen)


def test_delete(served):
    _, serve = served

    @serve.deployment(name="gone")
    class Echo:
        def __call__(self, x):
            return x

    h = serve.run(Echo.bind())
    assert h.remote(3).result(timeout=30) == 3
    serve.delete("gone")
    assert "gone" not in serve.status()
    with pytest.raises(Exception, match="no deployment named"):
        serve.get_deployment_handle("gone").remote(1).result(timeout=30)


def test_snapshots_flow_to_router(served):
    _, serve = served

    @serve.deployment(name="snapflow", num_replicas=2)
    class Echo:
        def __call__(self, x):
            return x

        def load_snapshot(self):
            return {"slots": 4, "waiting": 0}

    h = serve.run(Echo.bind())
    assert h.remote(1).result(timeout=30) == 1
    router = h._router
    deadline = time.time() + 30
    while time.time() < deadline:
        with router._lock:
            if len(router._loads) == 2 and router._fresh_loads():
                break
        time.sleep(0.1)
    with router._lock:
        fresh = router._fresh_loads()
    assert fresh is not None and len(fresh) == 2
    for s in fresh.values():
        assert "queue_depth" in s and "ts" in s and s["slots"] == 4
    before = router.stats()["scored_routes"]
    assert h.remote(2).result(timeout=30) == 2
    assert router.stats()["scored_routes"] == before + 1


def test_autoscaling_config_raises():
    """Since the autoscaling policy is ported, ``autoscaling_config`` no
    longer raises: the decorator and ``options`` keep it in the
    deployment's config, as ``ray_tpu``'s do (the controller's policy is
    held in tests/test_torch_serve_autoscale.py)."""
    auto = {"min_replicas": 1, "max_replicas": 3}
    configs = []
    for pkg in PACKAGES:
        serve = _serve(pkg)

        class A:
            pass

        d = serve.deployment(autoscaling_config=auto)(A)
        o = serve.deployment(A).options(autoscaling_config=auto)
        assert d._config["autoscaling_config"] == auto
        assert o._config["autoscaling_config"] == auto
        configs.append(d._config)
    assert configs[0] == configs[1]


def _serve_threads(skip=()):
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.ident not in skip and t.name.startswith(
                ("serve-", "llm-", "actor-loop"))]


def test_shutdown_leaves_no_serve_thread():
    import ray_tpu_torch
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Slow:
        def __call__(self, x):
            return x

        def stream(self, n):
            yield from range(n)

    # Threads an earlier test on ray_tpu's runtime may still be closing.
    before = {t.ident for t in threading.enumerate()}
    ray_tpu_torch.init(local_mode=True)
    try:
        h = serve.run(Slow.bind())
        assert h.remote(1).result(timeout=30) == 1
        assert list(h.options("stream", stream=True).remote(3)) == [0, 1, 2]
        assert any(n.startswith("serve-longpoll")
                   for n in _serve_threads(before))
        t0 = time.monotonic()
        serve.shutdown()
        took = time.monotonic() - t0
        assert _serve_threads(before) == [], _serve_threads(before)
        assert took < 15.0
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


# --------------------------------- tests/test_serve_routing.py unit tier


def _ns(pkg):
    """One package's router world: Router, config, chain hashes, and the
    two helpers of test_serve_routing.py."""
    router_mod = importlib.import_module(f"{pkg}.serve._private.router")
    cfg = importlib.import_module(f"{pkg}.core.config").GLOBAL_CONFIG
    kv = importlib.import_module(f"{pkg}.serve.engine.kv_manager")
    ctrl = importlib.import_module(f"{pkg}.serve._private.controller")
    Router = router_mod.Router

    def make_router(replicas, loads=None):
        r = Router.__new__(Router)
        r._controller = None
        r._deployment = "unit"
        r._lock = threading.Lock()
        r._replicas = []
        r._version = -1
        r._load_gen = -1
        r._loads = {}
        r._inflight = {}
        r._model_affinity = {}
        r._scored_routes = 0
        r._pow2_routes = 0
        r._affinity_routes = 0
        r._poller_started = True  # unit mode: never spawn the long-poller
        r._poll_thread = None
        r._stopped = False
        r._apply(1, replicas, 1, loads)
        return r

    def snap(**kw):
        base = {"ts": time.time(), "queue_depth": 0, "waiting": 0,
                "slots": 4, "kv_free_blocks": 8, "kv_total_blocks": 8,
                "prefix_block_size": 4, "prefix_hashes": []}
        base.update(kw)
        return base

    return types.SimpleNamespace(Router=Router, cfg=cfg,
                                 chain_hashes=kv.chain_hashes,
                                 ServeController=ctrl.ServeController,
                                 make_router=make_router, snap=snap)


def _choose(r, obs, **kw):
    """choose() with the decision record (path taken, score, depth)."""
    decision = {}
    c = r.choose(decision=decision, **kw)
    obs.append((c, decision))
    return c


def sc_scored_prefers_prefix_affinity(ns, obs, mp):
    prompt = list(range(16))
    chain = ns.chain_hashes(prompt, 4)
    r = ns.make_router(["a", "b", "c"],
                       [ns.snap(), ns.snap(prefix_hashes=chain), ns.snap()])
    for _ in range(8):
        choice = _choose(r, obs, prefix_tokens=prompt)
        assert choice == "b"
        r.done(choice)
    st = r.stats()
    obs.append(st)
    assert st["scored_routes"] == 8
    assert st["affinity_routes"] == 8
    assert st["pow2_routes"] == 0


def sc_deeper_prefix_match_wins(ns, obs, mp):
    prompt = list(range(16))
    chain = ns.chain_hashes(prompt, 4)
    r = ns.make_router(["shallow", "deep"],
                       [ns.snap(prefix_hashes=chain[:1]),
                        ns.snap(prefix_hashes=chain[:3])])
    assert _choose(r, obs, prefix_tokens=prompt) == "deep"


def sc_scored_prefers_short_queue(ns, obs, mp):
    r = ns.make_router(["busy", "idle"],
                       [ns.snap(queue_depth=6), ns.snap(queue_depth=0)])
    assert _choose(r, obs) == "idle"


def sc_engine_waiting_counts_as_queue_pressure(ns, obs, mp):
    r = ns.make_router(["stuffed", "free"],
                       [ns.snap(queue_depth=1, waiting=9),
                        ns.snap(queue_depth=2)])
    assert _choose(r, obs) == "free"


def sc_kv_pressure_breaks_ties(ns, obs, mp):
    r = ns.make_router(["full", "roomy"],
                       [ns.snap(kv_free_blocks=0), ns.snap(kv_free_blocks=8)])
    assert _choose(r, obs) == "roomy"


def sc_affinity_loses_to_overload(ns, obs, mp):
    prompt = list(range(16))
    chain = ns.chain_hashes(prompt, 4)
    r = ns.make_router(["hot", "idle"],
                       [ns.snap(prefix_hashes=chain, queue_depth=20),
                        ns.snap()])
    assert _choose(r, obs, prefix_tokens=prompt) == "idle"


def sc_pow2_fallback_when_snapshots_stale(ns, obs, mp):
    stale = ns.snap()
    stale["ts"] = time.time() - 3600.0
    r = ns.make_router(["a", "b"], [stale, ns.snap()])
    mp.setattr(random, "sample", lambda seq, k: list(seq)[:k])
    r._inflight["a"] = 3
    assert _choose(r, obs) == "b"
    st = r.stats()
    obs.append(st)
    assert st["pow2_routes"] == 1 and st["scored_routes"] == 0


def sc_age_restamps_freshness_on_local_clock(ns, obs, mp):
    skewed = ns.snap(age_s=0.1)
    skewed["ts"] = time.time() - 3600.0
    r = ns.make_router(["a", "b"], [skewed, ns.snap(age_s=0.1)])
    _choose(r, obs)
    assert r.stats()["scored_routes"] == 1
    old = ns.snap(age_s=3600.0)
    old["ts"] = time.time()
    r2 = ns.make_router(["a", "b"], [old, ns.snap(age_s=3600.0)])
    _choose(r2, obs)
    obs.append((r.stats(), r2.stats()))
    assert r2.stats()["pow2_routes"] == 1


def sc_pow2_fallback_byte_compatible_with_legacy(ns, obs, mp):
    replicas = [f"r{i}" for i in range(5)]
    r = ns.make_router(replicas, loads=None)

    def legacy(replicas, inflight, rng):
        a, b = rng.sample(replicas, 2)
        return a if inflight.get(a, 0) <= inflight.get(b, 0) else b

    random.seed(1234)
    got = [_choose(r, obs) for _ in range(50)]
    random.seed(1234)
    inflight, want = {}, []
    for _ in range(50):
        c = legacy(replicas, inflight, random)
        inflight[c] = inflight.get(c, 0) + 1
        want.append(c)
    assert got == want


def sc_random_policy(ns, obs, mp):
    ns.cfg.set("serve_router_policy", "random")
    r = ns.make_router(["a", "b", "c"],
                       [ns.snap(queue_depth=99), ns.snap(queue_depth=99),
                        ns.snap()])
    seen = [_choose(r, obs) for _ in range(64)]
    assert set(seen) == {"a", "b", "c"}


def sc_done_underflow_guard(ns, obs, mp):
    r = ns.make_router(["a", "b"], [ns.snap(), ns.snap()])
    r.done("a")
    r.done("a")
    assert r._inflight["a"] == 0
    c = _choose(r, obs)
    assert r._inflight[c] == 1
    r.done(c)
    r.done(c)
    assert r._inflight[c] == 0
    counts = {"a": 0, "b": 0}
    for _ in range(4):
        counts[_choose(r, obs)] += 1
    assert counts["a"] >= 1 and counts["b"] >= 1, counts


def sc_candidate_subset_bounds_scoring_at_scale(ns, obs, mp):
    n = 200
    prompt = list(range(16))
    chain = ns.chain_hashes(prompt, 4)
    loads = [ns.snap() for _ in range(n)]
    loads[137] = ns.snap(prefix_hashes=chain)
    r = ns.make_router([f"r{i}" for i in range(n)], loads)
    for _ in range(8):
        choice = _choose(r, obs, prefix_tokens=prompt)
        assert choice == "r137"
        r.done(choice)
    st = r.stats()
    obs.append(st)
    assert st["scored_routes"] == 8
    bound = ns.cfg.serve_router_topk + ns.cfg.serve_router_affinity_cands + 1
    assert st["candidates_scored"] <= 8 * bound, st


def sc_session_affinity_pin_survives_index_outage(ns, obs, mp):
    n = 64
    prompt = list(range(16))
    chain = ns.chain_hashes(prompt, 4)
    loads = [ns.snap() for _ in range(n)]
    loads[50] = ns.snap(prefix_hashes=chain)
    r = ns.make_router([f"r{i}" for i in range(n)], loads)
    assert _choose(r, obs, prefix_tokens=prompt, session_key="u") == "r50"
    r.done("r50")
    old = ns.cfg.serve_router_affinity_cands
    ns.cfg.set("serve_router_affinity_cands", 0)  # index blind
    try:
        for _ in range(4):
            assert _choose(r, obs, prefix_tokens=prompt,
                           session_key="u") == "r50"
            r.done("r50")
    finally:
        ns.cfg.set("serve_router_affinity_cands", old)
    obs.append(r.stats())
    assert r.stats()["session_affinity_routes"] >= 4


def sc_session_affinity_lru_capped(ns, obs, mp):
    old = ns.cfg.serve_router_session_affinity_max
    ns.cfg.set("serve_router_session_affinity_max", 4)
    try:
        n = 32
        r = ns.make_router([f"r{i}" for i in range(n)],
                           [ns.snap() for _ in range(n)])
        for i in range(7):
            r.done(_choose(r, obs, session_key=f"s{i}"))
        obs.append(list(r._session_affinity.items()))
        assert len(r._session_affinity) == 4
        assert "s0" not in r._session_affinity
        assert "s6" in r._session_affinity
    finally:
        ns.cfg.set("serve_router_session_affinity_max", old)


def sc_apply_delta_updates_routing(ns, obs, mp):
    r = ns.make_router(["a", "b"], [ns.snap(queue_depth=9), ns.snap()])
    assert _choose(r, obs) == "b"
    r.done("b")
    assert r._apply_delta(1, {0: ns.snap(), 1: ns.snap(queue_depth=9)},
                          load_gen=2)
    assert _choose(r, obs) == "a"
    assert r._load_gen == 2
    assert not r._apply_delta(99, {0: ns.snap()})
    assert not r._apply_delta(1, {7: ns.snap()})


def sc_apply_delta_none_snapshot_drops_entry(ns, obs, mp):
    r = ns.make_router(["a", "b"], [ns.snap(), ns.snap()])
    assert r._apply_delta(1, {0: None})
    obs.append(sorted(r._loads))
    assert "a" not in r._loads and "b" in r._loads


def sc_controller_delta_since_unit(ns, obs, mp):
    d = {"replicas": ["a", "b", "c"],
         "loads": {"a": ns.snap(), "b": ns.snap(), "c": ns.snap()},
         "journal": collections.deque(
             [(5, frozenset({0})), (6, frozenset({1, 2}))], maxlen=8)}
    ds = ns.ServeController._delta_since
    obs.append([sorted(ds(None, d, 5)), ds(None, d, 6), ds(None, d, 4),
                ds(None, d, 7)])
    assert set(ds(None, d, 5)) == {1, 2}
    assert ds(None, d, 6) == {}
    assert ds(None, d, 4) is None
    assert ds(None, d, 7) is None


def sc_stop_joins_poller(ns, obs, mp):
    r = ns.make_router(["a"], [ns.snap()])
    done = threading.Event()

    def fake_poll():
        while not r._stopped:
            time.sleep(0.01)
        done.set()

    t = threading.Thread(target=fake_poll, daemon=True)
    r._poll_thread = t
    t.start()
    r.stop()
    assert done.wait(2.0)
    t.join(timeout=2.0)
    assert not t.is_alive()


def sc_router_fleet_term_scores_spilled_residency(ns, obs, mp):
    """tests/test_kv_fleet.py:360: score identity at weight 0, a fleet
    boost when the deployment opts in, on a __new__-built Router."""
    block = 8
    prompt = list(range(48))
    chain = ns.chain_hashes(prompt, block)
    cold = {"slots": 4, "waiting": 0, "prefix_block_size": block}
    warm = dict(cold, fleet_kv_hashes=frozenset(chain))

    r = ns.Router.__new__(ns.Router)
    r._inflight = {}
    s_cold, _ = r._score("a", cold, chain, len(prompt))
    s_warm, _ = r._score("b", warm, chain, len(prompt))
    obs.append((s_cold, s_warm))
    assert s_cold == s_warm

    r._weights = {"fleet": 1.0}
    s_cold, _ = r._score("a", cold, chain, len(prompt))
    s_warm, d = r._score("b", warm, chain, len(prompt))
    obs.append((s_cold, s_warm, d))
    assert s_warm > s_cold
    assert d == 0
    r._weights = {"prefix": 1.5, "fleet": 0.75}
    hbm = dict(cold, prefix_hashes=frozenset(chain))
    s_hbm, d_hbm = r._score("c", hbm, chain, len(prompt))
    s_warm, _ = r._score("b", warm, chain, len(prompt))
    obs.append((s_hbm, d_hbm, s_warm))
    assert s_hbm > s_warm and d_hbm == len(chain)


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_router_matches_ray_tpu(scenario, monkeypatch):
    """The same scenario on both Routers: same choices, route counters
    and scores (each run also keeps ray_tpu's test's own asserts)."""
    seen = {}
    for pkg in PACKAGES:
        ns = _ns(pkg)
        old = ns.cfg.serve_router_policy
        ns.cfg.set("serve_router_policy", "scored")
        obs = []
        state = random.getstate()
        random.seed(4321)
        try:
            with monkeypatch.context() as mp:
                scenario(ns, obs, mp)
        finally:
            random.setstate(state)
            ns.cfg.set("serve_router_policy", old)
        seen[pkg] = obs
    assert seen["ray_tpu_torch"] == seen["ray_tpu"]
