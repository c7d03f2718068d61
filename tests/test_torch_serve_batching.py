"""``@serve.batch`` in the port (``ray_tpu_torch/serve/batching.py``)
against ``ray_tpu``'s.

- Batch formation: the same seeded arrival order (numpy seeds) of calls
  and timer expiries through both packages' ``_BatchQueue``: the same
  batches, results and errors (mismatched extra arguments, a wrong result
  count, a raising function).
- ``tests/test_serve.py``'s two batching cases, on both packages'
  in-process runtimes: calls collapse into batches, and a batched method
  of a deployment.
- Per-instance queues: two instances of one class in one process never
  share a batch, and decorated classes ship to a replica by value.
"""

import concurrent.futures as cf
import importlib
import threading

import numpy as np
import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def _batching(pkg):
    return importlib.import_module(f"{pkg}.serve.batching")


def _run_trace(pkg, seed):
    """Single-threaded: each step submits a call (sometimes with an odd
    extra argument) or expires the timer (``_flush``). Returns the batches
    the function saw and every call's outcome."""
    rng = np.random.RandomState(seed)
    seen = []

    def fn(xs, scale=1, fail=False):
        seen.append(list(xs))
        if fail:
            raise RuntimeError("batch function failed")
        if len(xs) == 3 and scale == 7:
            return xs[:-1]  # wrong count on purpose
        return [x * scale for x in xs]

    q = _batching(pkg)._BatchQueue(fn, int(rng.randint(2, 6)), 3600.0)
    futs = []
    for _ in range(200):
        r = rng.rand()
        if r < 0.8:
            x = int(rng.randint(100))
            kw = {}
            if rng.rand() < 0.05:
                kw["scale"] = 7
            if rng.rand() < 0.03:
                kw["fail"] = True
            futs.append(q.submit(None, (x,), kw))
        else:
            q._flush()
    q._flush()
    outcomes = []
    for f in futs:
        e = f.exception(timeout=5)
        outcomes.append(("err", type(e).__name__, str(e)) if e is not None
                        else ("ok", f.result()))
    if q._timer is not None:
        q._timer.cancel()
    return seen, outcomes


@pytest.mark.parametrize("seed", range(6))
def test_batch_formation_equals_ray_tpus(seed):
    ref = _run_trace("ray_tpu", seed)
    got = _run_trace("ray_tpu_torch", seed)
    assert got == ref
    seen, outcomes = got
    assert any(len(b) > 1 for b in seen)
    assert any(o[0] == "err" for o in outcomes) or seed % 2


def test_timer_flushes_a_partial_batch():
    for pkg in PACKAGES:
        sizes = []
        q = _batching(pkg)._BatchQueue(
            lambda xs: (sizes.append(len(xs)), xs)[1], 8, 0.05)
        futs = [q.submit(None, (i,), {}) for i in range(3)]
        assert [f.result(timeout=5) for f in futs] == [0, 1, 2]
        assert sizes == [3], pkg


# ------------------------------------------------------ tests/test_serve.py


@pytest.fixture(params=PACKAGES)
def local(request):
    pkg = importlib.import_module(request.param)
    serve = importlib.import_module(f"{request.param}.serve")
    pkg.init(local_mode=True)
    try:
        yield serve
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()


def test_serve_batch_collapses_calls(local):
    serve = local
    calls = []

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
    def compute(xs):
        calls.append(len(xs))
        return [x * 10 for x in xs]

    with cf.ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(compute, range(8)))
    assert outs == [x * 10 for x in range(8)]
    assert max(calls) > 1


def test_batch_in_deployment(local):
    serve = local

    @serve.deployment(max_ongoing_requests=8)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, xs):
            self.batch_sizes.append(len(xs))
            return [x + 100 for x in xs]

        def sizes(self):
            return self.batch_sizes

    h = serve.run(Batched.bind())
    rs = [h.remote(i) for i in range(8)]
    assert [r.result(timeout=60) for r in rs] == [i + 100 for i in range(8)]
    assert max(h.sizes.remote().result(timeout=60)) > 1


def test_two_instances_never_share_a_batch():
    from ray_tpu_torch import serve

    class Model:
        def __init__(self, tag):
            self.tag = tag
            self.batches = []

        @serve.batch(max_batch_size=16, batch_wait_timeout_s=0.1)
        def __call__(self, xs):
            self.batches.append(list(xs))
            return [(self.tag, x) for x in xs]

    a, b = Model("a"), Model("b")
    with cf.ThreadPoolExecutor(8) as pool:
        fa = [pool.submit(a, i) for i in range(4)]
        fb = [pool.submit(b, i) for i in range(4)]
        assert [f.result(timeout=10) for f in fa] == [("a", i)
                                                      for i in range(4)]
        assert [f.result(timeout=10) for f in fb] == [("b", i)
                                                      for i in range(4)]
    assert sorted(x for bt in a.batches for x in bt) == [0, 1, 2, 3]
    assert sorted(x for bt in b.batches for x in bt) == [0, 1, 2, 3]


def test_decorated_class_pickles_by_value():
    import cloudpickle

    from ray_tpu_torch import serve

    @serve.deployment
    class Shipped:
        @serve.batch(max_batch_size=2, batch_wait_timeout_s=0.05)
        def __call__(self, xs):
            return [x + 1 for x in xs]

    Shipped.bind()._cls()(1)  # a queue now exists on an instance
    cls = cloudpickle.loads(cloudpickle.dumps(Shipped._cls))
    inst = cls()
    out = [None, None]

    def call(i):
        out[i] = inst(i)

    ts = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert out == [1, 2]
